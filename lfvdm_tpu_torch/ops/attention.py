"""The video U-Net's two attention kernels, their plain versions and wrappers.

* ``spatial_attention`` replaces ``lfvdm_tpu/ops/attention.py::_spatial_kernel``:
  softmax(q kᵀ) v over the H·W pixel tokens of each (batch, frame, head).
  CUDA source: ``csrc/spatial_attention.cu``, a flash-attention forward
  (64-query blocks, 64-key tiles, online f32 softmax, K/V tiles in shared
  memory). At the flagship shapes the bf16 work sits under the H100's
  operations-per-byte balance, so the bound is bytes; the kernel never writes
  the (D, D) logits, so it moves only q, k, v and out.

* ``temporal_rpe_attention`` replaces
  ``lfvdm_tpu/ops/attention.py::_temporal_kernel``: attention over the
  T ≤ 32 frames at every pixel site, with iRPE biases on the logits
  (q·R_k, k·R_qᵀ) and the output (attn·R_v) and the two-group mask rebuilt
  from a per-frame {0, 1} mask. CUDA source:
  ``csrc/temporal_rpe_attention.cu``, one thread per (query frame, site),
  the softmax over S ≤ 32 in registers. The bound is bytes (T is far too
  short to keep any matrix unit busy); sites on adjacent threads make every
  q/k/v access one contiguous run.

Each wrapper takes the plain version for CPU tensors and launches its kernel
for CUDA tensors (any other device raises); ``impl="plain"`` asks for the
plain version on any device, for comparisons. ``<wrapper>.launches`` counts
kernel launches. The kernels have no backward: an ``autograd.Function``
replays the plain version under autograd, as the JAX package's
``custom_vjp``s differentiate their einsum oracles.

Layouts are the JAX kernels' (q pre-scaled by F**-0.5):
  spatial:  q, k, v, out   (B, T, H, D, F)
  temporal: q, k, v, out   (B, H, T, F, D)
            r_k, r_q_t     (B, H, T, S, F)   r_q_t[t, s] = R_q[s, t]·scale
            r_v_t          (B, H, T, F, S)
            mask           (B, T)            per-frame group in {0, 1}
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = torch.finfo(torch.float32).min
MAX_FRAMES = 32      # temporal kernel: frames held in registers
MAX_HEAD_DIM = 128   # spatial kernel: features per head
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_impl(impl: str):
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")


def _use_kernel(device: torch.device) -> bool:
    """CPU tensors take the plain version; CUDA tensors the kernel."""
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise RuntimeError(f"no attention kernel for device {device}")


def _check_kernel_inputs(tensors, dtype):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"inputs on different devices: {t.device} vs {dev}")
        if t.dtype != dtype:
            raise TypeError(f"inputs must share dtype {dtype}, got {t.dtype}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {dtype}")


def _check_launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# Spatial attention
# ---------------------------------------------------------------------------


def spatial_attention_plain(q, k, v):
    """softmax(q kᵀ) v with f32 logits and softmax; the weights are rounded to
    v's dtype before attn @ v (lfvdm_tpu ``spatial_attention_reference``)."""
    logits = torch.einsum("bthdf,bthef->bthde", q.float(), k.float())
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bthde,bthef->bthdf", attn.float(), v.float()).to(q.dtype)


def _spatial_launch(q, k, v):
    _check_kernel_inputs((q, k, v), q.dtype)
    B, T, H, D, F = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if F > MAX_HEAD_DIM:
        raise ValueError(f"spatial kernel takes F <= {MAX_HEAD_DIM}, got {F}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _build.function("spatial_attention", "lfvdm_spatial_attention",
                         [_I, _P, _P, _P, _P, _I, _I, _I, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), B * T * H, D, F, stream)
    _check_launch(rc, "spatial_attention")
    spatial_attention.launches += 1
    return out


class _SpatialAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if _use_kernel(q.device):
            return _spatial_launch(q, k, v)
        return spatial_attention_plain(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return _replay_plain(spatial_attention_plain, ctx.saved_tensors, g)


def spatial_attention(q, k, v, *, impl: str = "auto"):
    """Fused softmax(q kᵀ) v over tokens D. q, k, v: (B, T, H, D, F), q pre-scaled."""
    _check_impl(impl)
    if impl == "plain":
        return spatial_attention_plain(q, k, v)
    return _SpatialAttention.apply(q, k, v)


spatial_attention.launches = 0


# ---------------------------------------------------------------------------
# Temporal masked-RPE attention
# ---------------------------------------------------------------------------


def temporal_rpe_attention_plain(q, k, v, r_k, r_q_t, r_v_t, mask):
    """Einsum form in kernel layout (lfvdm_tpu ``temporal_rpe_attention_reference``)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bhtfd,bhsfd->bhtsd", qf, kf)
    logits = logits + torch.einsum("bhtsf,bhtfd->bhtsd", r_k.float(), qf)
    logits = logits + torch.einsum("bhtsf,bhsfd->bhtsd", r_q_t.float(), kf)
    m = mask.float()
    allowed = m[:, :, None] * m[:, None, :] + (1 - m[:, :, None]) * (1 - m[:, None, :])
    logits = torch.where(allowed[:, None, :, :, None] > 0.5, logits,
                         torch.full_like(logits, NEG_INF))
    attn = torch.softmax(logits, dim=3).to(q.dtype).float()
    out = torch.einsum("bhtsd,bhsfd->bhtfd", attn, vf)
    out = out + torch.einsum("bhtfs,bhtsd->bhtfd", r_v_t.float(), attn)
    return out.to(q.dtype)


def _temporal_launch(q, k, v, r_k, r_q_t, r_v_t, mask):
    _check_kernel_inputs((q, k, v, r_k, r_q_t, r_v_t), q.dtype)
    B, H, T, F, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if r_k.shape != (B, H, T, T, F) or r_q_t.shape != (B, H, T, T, F):
        raise ValueError(f"r_k/r_q_t must be {(B, H, T, T, F)}, got {r_k.shape}, {r_q_t.shape}")
    if r_v_t.shape != (B, H, T, F, T):
        raise ValueError(f"r_v_t must be {(B, H, T, F, T)}, got {r_v_t.shape}")
    if mask.shape != (B, T) or mask.device != q.device:
        raise ValueError(f"mask must be {(B, T)} on {q.device}, got {mask.shape} on {mask.device}")
    if T > MAX_FRAMES:
        raise ValueError(f"temporal kernel takes T <= {MAX_FRAMES} frames, got {T}")
    q, k, v, r_k, r_q_t, r_v_t = (t.contiguous() for t in (q, k, v, r_k, r_q_t, r_v_t))
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    fn = _build.function("temporal_rpe_attention", "lfvdm_temporal_rpe_attention",
                         [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                r_k.data_ptr(), r_q_t.data_ptr(), r_v_t.data_ptr(), mask.data_ptr(),
                out.data_ptr(), B, H, T, F, D, stream)
    _check_launch(rc, "temporal_rpe_attention")
    temporal_rpe_attention.launches += 1
    return out


class _TemporalRPEAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, r_k, r_q_t, r_v_t, mask):
        ctx.save_for_backward(q, k, v, r_k, r_q_t, r_v_t, mask)
        if _use_kernel(q.device):
            return _temporal_launch(q, k, v, r_k, r_q_t, r_v_t, mask)
        return temporal_rpe_attention_plain(q, k, v, r_k, r_q_t, r_v_t, mask)

    @staticmethod
    def backward(ctx, g):
        *diff, mask = ctx.saved_tensors
        grads = _replay_plain(
            lambda *a: temporal_rpe_attention_plain(*a, mask), diff, g)
        return (*grads, None)


def temporal_rpe_attention(q, k, v, r_k, r_q_t, r_v_t, mask, *, impl: str = "auto"):
    """Two-group-masked RPE attention over frames; see the module docstring
    for layouts. Returns (B, H, T, F, D) in q's dtype."""
    _check_impl(impl)
    if impl == "plain":
        return temporal_rpe_attention_plain(q, k, v, r_k, r_q_t, r_v_t, mask)
    return _TemporalRPEAttention.apply(q, k, v, r_k, r_q_t, r_v_t, mask)


temporal_rpe_attention.launches = 0


def _replay_plain(plain, saved, g):
    """Gradients of ``plain`` at ``saved`` against cotangent ``g``."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in saved]
        out = plain(*inputs)
    return torch.autograd.grad(out, inputs, g.to(out.dtype))


def reset_launch_counts():
    spatial_attention.launches = 0
    temporal_rpe_attention.launches = 0


def launch_counts() -> dict:
    return {"temporal_rpe_attention": temporal_rpe_attention.launches,
            "spatial_attention": spatial_attention.launches}
