"""The single-pass AdamW + EMA kernel (``ops/adamw.py``,
``csrc/fused_adamw_ema.cu``) against its plain version on the card.

Marked ``cuda``: each test skips without a CUDA device (as on a CPU-only
machine). On a machine with a card, and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adamw_cuda.py

Tensors of many sizes (empty, odd, unaligned views, one longer than a
launch's blocks, more of them than a launch's slots), f32 and bf16 EMA
copies, 0 to 4 rates, with and without a schedule factor: the kernel equals
the plain version to a few f32 ulps (the compiler fuses multiply-adds the
plain version rounds apart) and a bf16 copy to one bf16 ulp; a non-finite
flag leaves every bit; a captured launch replays on new gradient values and
counts; the operator passes ``torch.library.opcheck`` on the card.
"""

import pytest
import torch

from lfvdm_tpu_torch.ops import adamw

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-6  # f32 state: a few ulps of fused multiply-adds
BF16_RTOL = 2.0 ** -7  # one bf16 ulp (8 significant bits), either side of a rounding


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tensors(sizes, n_rates, ema_dtype, gen, device, offset=0):
    """(params, grads, exp_avg, exp_avg_sq, emas): each tensor a view of
    ``offset`` f32 elements into a fresh buffer (1: 4-byte aligned only)."""

    def rnd(n, scale=1.0, dtype=torch.float32):
        buf = torch.randn(n + offset, generator=gen, device=device) * scale
        return buf[offset:].to(dtype) if dtype != torch.float32 else buf[offset:]

    params = [rnd(n) for n in sizes]
    grads = [rnd(n, 0.1) for n in sizes]
    exp_avg = [rnd(n, 0.01) for n in sizes]
    exp_avg_sq = [rnd(n, 1e-3).abs() for n in sizes]
    emas = [[(p + rnd(n, 0.01)).to(ema_dtype) for p, n in zip(params, sizes)]
            for _ in range(n_rates)]
    return params, grads, exp_avg, exp_avg_sq, emas


def _clone(state):
    params, grads, exp_avg, exp_avg_sq, emas = state
    return ([t.clone() for t in params], grads, [t.clone() for t in exp_avg],
            [t.clone() for t in exp_avg_sq], [[t.clone() for t in c] for c in emas])


def _run(state, finite, count, factor, rates, impl):
    params, grads, exp_avg, exp_avg_sq, emas = state
    adamw.fused_adamw_ema(params, grads, exp_avg, exp_avg_sq, emas, finite, count, lr=1e-3,
                          weight_decay=0.01, rates=rates, lr_factor=factor, impl=impl)


def _assert_close(got, want):
    g_params, _, g_m, g_v, g_emas = got
    w_params, _, w_m, w_v, w_emas = want
    for a, b in zip(g_params + g_m + g_v, w_params + w_m + w_v):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for ca, cb in zip(g_emas, w_emas):
        for a, b in zip(ca, cb):
            rtol = BF16_RTOL if a.dtype == torch.bfloat16 else RTOL
            torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=ATOL)


SIZES = [0, 1, 3, 4, 7, 8191, 8192, 8193, 40000, 5]


@pytest.mark.parametrize("ema_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rates", [0, 1, 2, 4])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("factor", [None, 0.25])
def test_kernel_matches_plain(cuda, ema_dtype, n_rates, offset, factor):
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = _tensors(SIZES, n_rates, ema_dtype, gen, cuda, offset)
    rates = [0.9999, 0.99, 0.9, 0.5][:n_rates]
    finite = torch.tensor(True, device=cuda)
    count = torch.tensor(3, dtype=torch.int64, device=cuda)
    f = None if factor is None else torch.tensor(factor, device=cuda)
    want, got = _clone(state), _clone(state)
    before = adamw.fused_adamw_ema.launches
    _run(got, finite, count, f, rates, "auto")
    _run(want, finite, count, f, rates, "plain")
    torch.cuda.synchronize()
    assert adamw.fused_adamw_ema.launches == before + 1
    assert adamw.fused_adamw_ema.launches_per_call == 1
    _assert_close(got, want)
    assert not torch.equal(got[0][-2], state[0][-2])  # the parameters moved


def test_launches_split_over_slots_and_blocks(cuda):
    """More tensors than a launch's 128 slots and one tensor longer than its
    1024 blocks of 8192 elements: several launches, the plain result."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    sizes = [37 + i for i in range(300)] + [9_000_000] + [11] * 5
    state = _tensors(sizes, 2, torch.bfloat16, gen, cuda)
    finite = torch.tensor(True, device=cuda)
    count = torch.tensor(0, dtype=torch.int64, device=cuda)
    want, got = _clone(state), _clone(state)
    _run(got, finite, count, None, [0.9999, 0.99], "auto")
    _run(want, finite, count, None, [0.9999, 0.99], "plain")
    torch.cuda.synchronize()
    assert adamw.fused_adamw_ema.launches_per_call >= 4
    _assert_close(got, want)


def test_nonfinite_flag_writes_nothing(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    state = _tensors(SIZES, 2, torch.bfloat16, gen, cuda)
    got = _clone(state)
    _run(got, torch.tensor(False, device=cuda), torch.tensor(5, dtype=torch.int64, device=cuda),
         None, [0.9999, 0.99], "auto")
    torch.cuda.synchronize()
    for a, b in zip(got[0] + got[2] + got[3] + got[4][0] + got[4][1],
                    state[0] + state[2] + state[3] + state[4][0] + state[4][1]):
        assert torch.equal(a, b)


def test_captured_launch_replays_on_new_values(cuda):
    """Captured once, the launch reads the gradients, flag, count and factor
    from their addresses at every replay: each replay equals an eager call
    on the same values, and a replay with the flag false writes nothing."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    state = _tensors([4097, 8192, 13], 1, torch.float32, gen, cuda)
    eager = _clone(state)
    finite = torch.tensor(True, device=cuda)
    count = torch.tensor(0, dtype=torch.int64, device=cuda)
    factor = torch.tensor(1.0, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _run(_clone(state), finite, count, factor, [0.99], "auto")  # warm-up: builds, loads
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _run(state, finite, count, factor, [0.99], "auto")
    for step, flag in enumerate((True, True, False, True)):
        for g in state[1]:
            g.copy_(torch.randn(g.shape, generator=gen, device=cuda) * 0.1)
        finite.fill_(flag)
        factor.fill_(1.0 - 0.1 * step)
        graph.replay()
        _run(eager, finite, count, factor, [0.99], "auto")
        count.add_(finite)
        torch.cuda.synchronize()
        for a, b in zip(state[0] + state[2] + state[3] + state[4][0],
                        eager[0] + eager[2] + eager[3] + eager[4][0]):
            assert torch.equal(a, b), step


def test_operator_passes_opcheck_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    params, grads, exp_avg, exp_avg_sq, emas = _tensors([5, 64], 1, torch.bfloat16, gen, cuda)
    args = (params, grads, exp_avg, exp_avg_sq, emas[0], torch.tensor(True, device=cuda),
            torch.tensor(2, dtype=torch.int64, device=cuda), None,
            adamw.hyperparameters(1e-3, 0.01, (0.9, 0.999), 1e-8, [0.99]))
    torch.library.opcheck(torch.ops.lfvdm.fused_adamw_ema.default, args)
