"""The port's fused consensus-entropy wrapper against the JAX package.

On the CPU ``consensus_entropy_tpu_torch.kernels.linear_mc`` runs its plain
PyTorch version; the JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas_scoring.py does.  Every case of that file is held here.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import os
import re

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.experimental import pallas_scoring
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.kernels import build, linear_mc

torch.set_num_threads(1)

# The repo's entropy gate (tests/test_pallas_scoring.py): float32 sums taken
# in another order than the Pallas kernel's.
RTOL, ATOL = 1e-5, 1e-6


def _make_problem(rng, m=3, n=50, k_frames=2, f=12, c=4):
    x = rng.standard_normal((n, k_frames, f)).astype(np.float32)
    w = (rng.standard_normal((m, f, c)) / np.sqrt(f)).astype(np.float32)
    b = (rng.standard_normal((m, c)) * 0.1).astype(np.float32)
    return x, w, b


def _jax_score(x, w, b, mask, *, k, tile_n, pack=1, **kw):
    """JAX packed_score_mc over the padded, tiled pool, trimmed to N."""
    n = x.shape[0]
    x_tiles, _ = pallas_scoring.pack_pool(x, tile_n, pack)
    w_p, b_p = pallas_scoring.pack_weights(w, b, pack)
    padded = np.zeros(x_tiles.shape[0] * tile_n, bool)
    padded[:n] = mask
    ent, values, idx = pallas_scoring.packed_score_mc(
        x_tiles, w_p, b_p, padded, n_members=w.shape[0] * pack, k=k,
        interpret=True, **kw)
    return np.asarray(ent)[:n], np.asarray(values), np.asarray(idx)


def _port_score(x, w, b, mask, *, k, **kw):
    w_p, b_p = convert.linear_members_from_jax(w, b, device="cpu")
    ent, values, idx = linear_mc.linear_score_mc(
        torch.from_numpy(x), w_p, b_p, torch.from_numpy(mask),
        n_members=w.shape[0], k=k, **kw)
    return ent.numpy(), values.numpy(), idx.numpy()


def _assert_entropy(port, ref):
    np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
    live = ~np.isneginf(ref)
    np.testing.assert_allclose(port[live], ref[live], rtol=RTOL, atol=ATOL)


def _assert_selection(port_v, port_i, ref_v, ref_i):
    """Indices equal where values > -inf (elsewhere they carry no meaning)."""
    live = ref_v > -np.inf
    np.testing.assert_array_equal(port_v > -np.inf, live)
    np.testing.assert_array_equal(port_i[live], ref_i[live])
    np.testing.assert_allclose(port_v[live], ref_v[live], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,tile_n", [(48, 16), (50, 32)])
def test_entropy_parity(rng, n, tile_n):
    # (50, 32) is the uneven pool JAX pads and trims; the port masks instead.
    x, w, b = _make_problem(rng, n=n)
    ref = pallas_scoring.linear_consensus_entropy(x, w, b, tile_n=tile_n,
                                                  interpret=True)
    ent = linear_mc.linear_consensus_entropy(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert ent.shape == (n,)
    np.testing.assert_allclose(ent.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_pack_weights_layout(rng):
    _, w, b = _make_problem(rng, m=2, f=5)
    w_p, b_p = linear_mc.pack_weights(torch.from_numpy(w), torch.from_numpy(b))
    assert w_p.shape == (5, 8) and b_p.shape == (8,)
    # Column block m of the packed matrix is member m's weight matrix.
    np.testing.assert_array_equal(w_p[:, 4:8].numpy(), w[1])
    np.testing.assert_array_equal(b_p[4:8].numpy(), b[1])
    jw, jb = pallas_scoring.pack_weights(w, b)
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b_p.numpy(), np.asarray(jb))


@pytest.mark.parametrize("fuse_topk", [False, True])
def test_score_matches_jax(rng, fuse_topk):
    x, w, b = _make_problem(rng, m=4, n=64, k_frames=3)
    mask = np.ones(64, bool)
    mask[60:] = False
    ref = _jax_score(x, w, b, mask, k=8, tile_n=16, fuse_topk=fuse_topk)
    ent, values, idx = _port_score(x, w, b, mask, k=8, fuse_topk=fuse_topk)
    _assert_entropy(ent, ref[0])
    assert np.all(np.isneginf(ent[~mask]))
    _assert_selection(values, idx, ref[1], ref[2])


@pytest.mark.parametrize("fuse_topk", [False, True])
def test_ties_across_tiles_and_masked_tile(rng, fuse_topk):
    # Duplicate rows give exact entropy ties; 'fast' = lowest index wins.
    x, w, b = _make_problem(rng, m=3, n=40, k_frames=2)
    x[7] = x[3]
    x[25] = x[3]
    mask = np.ones(40, bool)
    mask[8:16] = False   # a fully masked JAX tile
    ref = _jax_score(x, w, b, mask, k=6, tile_n=8, fuse_topk=fuse_topk)
    ent, values, idx = _port_score(x, w, b, mask, k=6, fuse_topk=fuse_topk)
    _assert_entropy(ent, ref[0])
    _assert_selection(values, idx, ref[1], ref[2])
    assert ent[7] == ent[3] == ent[25]


@pytest.mark.parametrize("fuse_topk", [False, True])
def test_fewer_valid_than_k(rng, fuse_topk):
    x, w, b = _make_problem(rng, m=2, n=16, k_frames=1)
    mask = np.zeros(16, bool)
    mask[[2, 5, 9]] = True
    ref = _jax_score(x, w, b, mask, k=5, tile_n=8, fuse_topk=fuse_topk)
    ent, values, idx = _port_score(x, w, b, mask, k=5, fuse_topk=fuse_topk)
    assert np.sum(values > -np.inf) == 3
    assert set(idx[:3].tolist()) == {2, 5, 9}
    _assert_entropy(ent, ref[0])
    _assert_selection(values, idx, ref[1], ref[2])


@pytest.mark.parametrize("fuse_topk", [False, True])
def test_numpy_tie_break(rng, fuse_topk):
    # 'numpy' ranks ties highest index first and never takes the fused path.
    x, w, b = _make_problem(rng, m=3, n=40, k_frames=2)
    x[7] = x[3]
    x[25] = x[3]
    x[30] = x[3]
    mask = np.ones(40, bool)
    mask[30] = False
    ref = _jax_score(x, w, b, mask, k=40, tile_n=8, fuse_topk=fuse_topk,
                     tie_break="numpy")
    ent, values, idx = _port_score(x, w, b, mask, k=40, fuse_topk=fuse_topk,
                                   tie_break="numpy")
    _assert_entropy(ent, ref[0])
    _assert_selection(values, idx, ref[1], ref[2])
    pos = {int(i): p for p, i in enumerate(idx)}
    assert pos[25] < pos[7] < pos[3]


@pytest.mark.parametrize("pack", [1, 2, 4])
def test_frame_packing_parity(rng, pack):
    # JAX packs P frames as P extra member copies; the port keeps pack=1 and
    # must give the same entropy, also from weights carried back from JAX.
    x, w, b = _make_problem(rng, m=3, n=32, k_frames=4, f=10)
    x_tiles, _ = pallas_scoring.pack_pool(x, tile_n=16, pack=pack)
    jw, jb = pallas_scoring.pack_weights(w, b, pack=pack)
    ref = np.asarray(pallas_scoring.packed_consensus_entropy(
        x_tiles, jw, jb, n_members=3 * pack, interpret=True))
    w_p, b_p, m = convert.from_jax_packed(jw, jb, pack, 3 * pack,
                                          device="cpu")
    assert m == 3
    xt = torch.from_numpy(x)
    ent, _, _ = linear_mc.linear_score_mc(
        xt, w_p, b_p, torch.ones(32, dtype=torch.bool), n_members=m, k=4)
    np.testing.assert_allclose(ent.numpy(), ref, rtol=RTOL, atol=ATOL)
    direct = linear_mc.linear_consensus_entropy(
        xt, torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(direct.numpy(), ent.numpy())


@pytest.mark.parametrize("fuse_topk", [False, True])
def test_bench_geometry_auto_pack(rng, fuse_topk):
    # bench.py at full scale runs M=16, K=4, C=4 with auto_pack's factor 2.
    pack = pallas_scoring.auto_pack(4, 16, 4)
    assert pack == 2
    x, w, b = _make_problem(rng, m=16, n=40, k_frames=4, f=20)
    mask = np.ones(40, bool)
    mask[::7] = False
    ref = _jax_score(x, w, b, mask, k=10, tile_n=16, pack=pack,
                     fuse_topk=fuse_topk)
    ent, values, idx = _port_score(x, w, b, mask, k=10, fuse_topk=fuse_topk)
    _assert_entropy(ent, ref[0])
    _assert_selection(values, idx, ref[1], ref[2])


def test_member_far_below_committee_max():
    # A member whose logits sit far below another member's max must still
    # contribute its own sharp softmax: the shift is per member, not per row.
    f = 8
    x = np.zeros((16, 1, f), np.float32)
    x[:, 0, 0] = 1.0
    w = np.zeros((2, f, 4), np.float32)
    w[0, 0] = [0.0, 0.0, 0.0, 80.0]
    w[1, 0] = [0.0, 0.0, 0.0, 5.0]
    b = np.zeros((2, 4), np.float32)
    ref = pallas_scoring.linear_consensus_entropy(x, w, b, tile_n=16,
                                                  interpret=True)
    ent = linear_mc.linear_consensus_entropy(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(ent.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _bad_inputs(case):
    x = torch.zeros(8, 2, 5)
    w = torch.zeros(5, 12)
    b = torch.zeros(12)
    mask = torch.ones(8, dtype=torch.bool)
    n_members = 3
    if case == "features":
        x = x[..., :-1].contiguous()
    elif case == "bias":
        b = torch.zeros(11)
    elif case == "members":
        n_members = 5
    elif case == "mask_shape":
        mask = torch.ones(7, dtype=torch.bool)
    elif case == "mask_dtype":
        mask = torch.ones(8)
    elif case == "dtype":
        x = x.double()
    elif case == "contiguity":
        x = torch.zeros(8, 5, 2).transpose(1, 2)
    elif case == "rank":
        x = x.reshape(16, 5)
    elif case == "frames":            # a song must fit one 64-row block
        x = torch.zeros(8, linear_mc.MAX_FRAMES + 1, 5)
    elif case == "columns":           # M*C must fit one wgmma (N <= 256)
        w, b, n_members = torch.zeros(5, 260), torch.zeros(260), 65
    elif case == "weights_too_big":   # W hi and lo over 227 KB of smem
        x, w, b = torch.zeros(8, 2, 400), torch.zeros(400, 64), torch.zeros(64)
        n_members = 16
    return x, w, b, mask, n_members


@pytest.mark.parametrize("case", ["features", "bias", "members", "mask_shape",
                                  "mask_dtype", "dtype", "contiguity", "rank",
                                  "frames", "columns", "weights_too_big"])
def test_shape_validation(case):
    x, w, b, mask, n_members = _bad_inputs(case)
    with pytest.raises(ValueError):
        linear_mc.linear_score_mc(x, w, b, mask, n_members=n_members, k=2)


def test_jax_rejects_what_the_port_rejects(rng):
    x, w, b = _make_problem(rng)
    x_tiles, _ = pallas_scoring.pack_pool(x, tile_n=16)
    w_p, b_p = pallas_scoring.pack_weights(w, b)
    with pytest.raises(ValueError):
        pallas_scoring.packed_consensus_entropy(
            x_tiles[..., :-1], w_p, b_p, n_members=3, interpret=True)
    port_w, port_b = convert.linear_members_from_jax(w, b, device="cpu")
    with pytest.raises(ValueError):
        linear_mc.linear_score_mc(
            torch.from_numpy(x[..., :-1].copy()), port_w, port_b,
            torch.ones(50, dtype=torch.bool), n_members=3, k=2)


def test_slice_shapes_fit_the_kernel():
    # configs[4]: M=16, C=4, F=260 needs 217,440 B of the 232,448 B limit.
    assert linear_mc.smem_bytes(260, 64) == 217_440 <= linear_mc.SMEM_LIMIT
    assert linear_mc.smem_bytes(20, 256) <= linear_mc.SMEM_LIMIT
    assert linear_mc.smem_bytes(400, 64) > linear_mc.SMEM_LIMIT


def _cuda_constants() -> dict:
    """The ``constexpr`` integers at the top of ``csrc/linear_mc.cu``, each
    evaluated from the ones before it."""
    with open(os.path.join(build.SRC_DIR, "linear_mc.cu")) as f:
        text = f.read()
    found = {}
    for name, expr in re.findall(
            r"^constexpr (?:int|size_t) (\w+) = ([^;]+);", text, re.M):
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))
    return found


@pytest.mark.parametrize("cuda_name,python_name", [
    ("CONSUMERS", "CONSUMERS"), ("STAGES", "STAGES"),
    ("BOX_ROWS_MAX", "BOX_ROWS"), ("BOX_F", "BOX_F"),
    ("LOGIT_STRIDE", "LOGIT_STRIDE"), ("MAX_TILE", "TILE_SONGS"),
    ("MAX_SMEM", "SMEM_LIMIT"), ("MAX_FRAMES", "MAX_FRAMES"),
    ("MAX_CLASSES", "MAX_CLASSES"), ("MAX_N", "MAX_MEMBER_COLUMNS")])
def test_validate_uses_the_kernel_layout(cuda_name, python_name):
    # validate() sizes shared memory with the Python names; the kernel's
    # source is the authority.
    assert _cuda_constants()[cuda_name] == getattr(linear_mc, python_name)


def test_fused_k_limit():
    x, w, b, mask, n_members = _bad_inputs(None)
    with pytest.raises(ValueError):
        linear_mc.linear_score_mc(x, w, b, mask, n_members=n_members,
                                  k=linear_mc.MAX_FUSED_K + 1, fuse_topk=True)
    # The unfused path has no such limit.
    _, values, _ = linear_mc.linear_score_mc(
        x, w, b, mask, n_members=n_members, k=linear_mc.MAX_FUSED_K + 1)
    assert values.shape == (8,)


def test_non_cpu_tensor_never_takes_the_plain_version():
    # Anything but a CPU tensor goes to the kernel, which takes only CUDA.
    x, w, b, mask, n_members = (t.to("meta") if isinstance(t, torch.Tensor)
                                else t for t in _bad_inputs(None))
    with pytest.raises(ValueError, match="CUDA"):
        linear_mc.linear_score_mc(x, w, b, mask, n_members=n_members, k=2)


def test_cpu_calls_do_not_count_launches(rng):
    before = linear_mc.launches
    x, w, b = _make_problem(rng, n=20)
    _port_score(x, w, b, np.ones(20, bool), k=3, fuse_topk=True)
    linear_mc.linear_consensus_entropy(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert linear_mc.launches == before == 0


@pytest.mark.parametrize("pack", [1, 2, 4])
def test_convert_round_trip(rng, pack):
    _, w, b = _make_problem(rng, m=3, f=6)
    w_p, b_p = convert.linear_members_from_jax(w, b, device="cpu")
    jw, jb = pallas_scoring.pack_weights(w, b, pack=pack)
    back_w, back_b, m = convert.from_jax_packed(np.asarray(jw),
                                                np.asarray(jb), pack,
                                                3 * pack, device="cpu")
    assert m == 3
    np.testing.assert_array_equal(back_w.numpy(), w_p.numpy())
    np.testing.assert_array_equal(back_b.numpy(), b_p.numpy())
    assert back_w.dtype == torch.float32 and back_w.is_contiguous()


def test_convert_rejects_non_replicas(rng):
    _, w, b = _make_problem(rng, m=3, f=6)
    jw, jb = (np.array(a) for a in pallas_scoring.pack_weights(w, b, pack=2))
    jw[0, -1] = 1.0   # off the block diagonal
    with pytest.raises(ValueError):
        convert.from_jax_packed(jw, jb, 2, 6, device="cpu")
    with pytest.raises(ValueError):
        convert.from_jax_packed(jw, jb, 2, 5, device="cpu")
    with pytest.raises(ValueError):
        convert.linear_members_from_jax(w[0], b, device="cpu")
