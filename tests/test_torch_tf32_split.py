"""The precision design of the port's ``linear_mc`` kernel, held on the CPU.

The kernel (``consensus_entropy_tpu_torch/csrc/linear_mc.cu``) runs the
member logits ``x . W`` on the tensor cores as 3xTF32: each float32 value
splits into ``hi = rna_tf32(v)`` and ``lo = rna_tf32(v - hi)`` and the
product is ``x_lo . W_hi + x_hi . W_lo + x_hi . W_hi`` in float32.  Here the
split is emulated with bit operations, as the kernel's ``to_tf32`` computes
it, and the resulting entropies are held against the JAX package's
``linear_consensus_entropy`` (the Pallas kernel in interpret mode) at the
bench's widths.  The kernel itself is held against the plain version on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.experimental import pallas_scoring
from consensus_entropy_tpu_torch.ops.entropy import shannon_entropy

torch.set_num_threads(1)

# The repo's entropy gate (tests/test_pallas_scoring.py).
RTOL, ATOL = 1e-5, 1e-6
# BASELINE.json configs[4] widths (bench.py's linear defaults), at a pool
# of 2,000 songs.
M, N, K, F, C = 16, 2000, 4, 260, 4


def rna_tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round float32 to 10 mantissa bits, to nearest
    with ties away from zero, by adding half of the dropped 13 bits to the
    magnitude and clearing them (the carry may step the exponent)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(v: torch.Tensor):
    hi = rna_tf32(v)
    return hi, rna_tf32(v - hi)


def entropy_from_logits(z: torch.Tensor, n_members: int) -> torch.Tensor:
    """The rest of the kernel's function on ``(N, K, M*C)`` logits: softmax
    shifted by each member's mean and clamped at 85, summed over frames and
    then members, normalised, entropy in nats."""
    n, k_frames, mc = z.shape
    z = z.view(n, k_frames, n_members, mc // n_members)
    e = torch.exp(torch.clamp_max(z - z.mean(dim=-1, keepdim=True), 85.0))
    probs = e / e.sum(dim=-1, keepdim=True)
    return shannon_entropy(probs.sum(dim=1).sum(dim=1))


def _bench_problem(seed):
    """bench.py::make_inputs: standard-normal frames, softmax-linear
    members."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, K, F), np.float32)
    w = rng.standard_normal((M, F, C), np.float32) / np.float32(np.sqrt(F))
    b = rng.standard_normal((M, C), np.float32) * np.float32(0.1)
    return x, w, b


def _packed(x, w, b):
    xt = torch.from_numpy(x).reshape(N * K, F)
    wt = torch.from_numpy(w).permute(1, 0, 2).reshape(F, M * C)
    return xt, wt, torch.from_numpy(b).reshape(M * C)


def _logits(xt, wt, bt, terms):
    (x_hi, x_lo), (w_hi, w_lo) = split(xt), split(wt)
    parts = {"x_lo.W_hi": (x_lo, w_hi), "x_hi.W_lo": (x_hi, w_lo),
             "x_hi.W_hi": (x_hi, w_hi)}
    z = torch.zeros(N * K, M * C)
    for name in terms:          # the kernel's order: small products first
        a, bw = parts[name]
        z = z + a @ bw
    return (z + bt).view(N, K, M * C)


THREE = ("x_lo.W_hi", "x_hi.W_lo", "x_hi.W_hi")


@pytest.fixture(scope="module")
def bench_case():
    x, w, b = _bench_problem(1987)
    ref = np.asarray(pallas_scoring.linear_consensus_entropy(
        x, w, b, tile_n=256, interpret=True))
    oracle = _float64_entropy(x, w, b)
    return x, w, b, ref, oracle


def _float64_entropy(x, w, b):
    z = (torch.from_numpy(x).double().reshape(N * K, F)
         @ torch.from_numpy(w).double().permute(1, 0, 2).reshape(F, M * C)
         + torch.from_numpy(b).double().reshape(M * C))
    return entropy_from_logits(z.view(N, K, M * C), M).numpy()


def test_three_tf32_products_keep_the_gate(bench_case):
    x, w, b, ref, _ = bench_case
    got = entropy_from_logits(_logits(*_packed(x, w, b), THREE), M).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_three_products_are_as_close_as_float32(bench_case):
    # Against a float64 chain: the split costs no accuracy the gate sees,
    # while one TF32 product is many times further off.
    x, w, b, _, oracle = bench_case
    xt, wt, bt = _packed(x, w, b)
    f32 = entropy_from_logits((xt @ wt + bt).view(N, K, M * C), M).numpy()
    three = entropy_from_logits(_logits(xt, wt, bt, THREE), M).numpy()
    one = entropy_from_logits(_logits(xt, wt, bt, ("x_hi.W_hi",)), M).numpy()
    err = {name: float(np.max(np.abs(v - oracle)))
           for name, v in (("f32", f32), ("3x", three), ("1x", one))}
    assert err["3x"] <= 2 * err["f32"] + 1e-7, err
    assert err["1x"] >= 10 * err["3x"], err
    assert err["3x"] < ATOL, err


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_split_reproduces_the_value(scale):
    rng = np.random.default_rng(7)
    v = torch.from_numpy(
        (rng.standard_normal(100_000) * scale).astype(np.float32))
    hi, lo = split(v)
    rel = ((hi.double() + lo.double() - v.double()).abs()
           / v.double().abs())
    assert float(rel.max()) <= 2.0 ** -22


def test_split_parts_are_tf32():
    rng = np.random.default_rng(8)
    v = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    for part in split(v):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # |lo| is at most half a TF32 step of hi: 2^-11 relative.
    hi, lo = split(v)
    assert float((lo.abs() / hi.abs()).max()) <= 2.0 ** -11


def test_rounding_is_to_nearest_ties_away():
    one = 1.0
    step = 2.0 ** -10                       # TF32 spacing at 1.0
    v = torch.tensor([one + step / 2,       # a tie: away from zero
                      -(one + step / 2),
                      one + step / 2 - 2.0 ** -23,   # just below: down
                      one + 3 * step / 2], dtype=torch.float32)
    got = rna_tf32(v).tolist()
    assert got == [one + step, -(one + step), one, one + 2 * step]
