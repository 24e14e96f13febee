"""Video datasets (host side, numpy)."""
