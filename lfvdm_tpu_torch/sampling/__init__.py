from .schemes import sampling_schemes  # noqa: F401
