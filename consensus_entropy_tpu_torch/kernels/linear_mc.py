"""Fused consensus entropy over softmax-linear members: the wrapper of
``csrc/linear_mc.cu`` and its plain PyTorch version.

Counterpart of ``consensus_entropy_tpu/experimental/pallas_scoring.py``
(``_kernel``, ``packed_score_mc``, ``linear_consensus_entropy``).  The pool
stays song-major ``(N, K, F)``: the TPU layout ``(n_tiles, K, tile_n, F)``,
``pack_pool`` and the frame packing of ``auto_pack`` work around Mosaic and
are not carried over.  Weights use ``pack_weights``' column-packed layout
``(F, M*C)`` / ``(M*C,)`` (``pack=1``).

On a CPU tensor the wrappers run :func:`plain_masked_entropy`; on a CUDA
tensor they launch the kernel or raise.  ``launches`` counts kernel launches
(the plain version never adds to it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from consensus_entropy_tpu_torch.kernels import build
from consensus_entropy_tpu_torch.ops.entropy import shannon_entropy
from consensus_entropy_tpu_torch.ops.topk import masked_top_k

#: Songs per thread block; each block writes its top-``k`` candidates.
TILE_SONGS = 128
#: Largest ``k`` the fused in-kernel top-k takes (one warp runs k passes
#: per tile); larger ``k`` raises — rank outside with ``fuse_topk=False``.
MAX_FUSED_K = 128

#: Launches of the CUDA kernel; set it to 0 to count a run.
launches = 0

#: What the kernel takes (``csrc/linear_mc.cu``): a song's frames fit one
#: 64-row tensor-core block, the member columns one ``wgmma`` (N <= 256),
#: and the weights, split into TF32 hi and lo, fit shared memory with the
#: feature ring and the logit scratch.
MAX_FRAMES = 64
MAX_MEMBER_COLUMNS = 256
MAX_CLASSES = 8
SMEM_LIMIT = 232_448            # bytes a block may opt in to on sm_90
#: The kernel's shared-memory layout, under the names ``csrc/linear_mc.cu``
#: gives them (``tests/test_torch_linear_mc.py`` holds the two in step).
CONSUMERS = 2                   # warpgroups, each with its logit scratch
STAGES = 6                      # feature boxes in the ring
BOX_ROWS = 64                   # rows per box: one m64 row block
BOX_F = 32                      # features per box: 128 B
LOGIT_STRIDE = 36               # floats per row of logit scratch


def smem_bytes(n_feat: int, mc: int) -> int:
    """Shared memory a block of the kernel needs, as ``smem_bytes`` in
    ``csrc/linear_mc.cu`` counts it: alignment slack, the ring of boxes,
    W hi and lo ``(N_pad, F_pad)`` with F padded to whole boxes, each
    warpgroup's logit scratch, the bias, two tiles of entropies and the
    ring barriers."""
    n_pad = 8
    while n_pad < mc:
        n_pad *= 2
    f_pad = -(-n_feat // BOX_F) * BOX_F
    return (1024 + STAGES * BOX_ROWS * BOX_F * 4 + 2 * n_pad * f_pad * 4
            + CONSUMERS * BOX_ROWS * LOGIT_STRIDE * 4 + n_pad * 4
            + 2 * TILE_SONGS * 4 + 2 * STAGES * 8)


def pack_weights(w: torch.Tensor, b: torch.Tensor):
    """Per-member ``(M, F, C)`` / ``(M, C)`` -> column-packed ``(F, M*C)`` /
    ``(M*C,)``: column block ``m`` is member ``m``'s weight matrix."""
    m, f, c = w.shape
    return (w.permute(1, 0, 2).reshape(f, m * c).contiguous(),
            b.reshape(m * c).contiguous())


def plain_masked_entropy(x: torch.Tensor, w_packed: torch.Tensor,
                         b_packed: torch.Tensor, mask: torch.Tensor,
                         n_members: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per-frame member logits,
    softmax shifted by each member's mean logit and clamped at +85, sum over
    frames then members, normalise, entropy in nats, ``-inf`` off ``mask``."""
    n, k_frames, n_feat = x.shape
    n_class = w_packed.shape[1] // n_members
    logits = (x.reshape(n * k_frames, n_feat) @ w_packed + b_packed).view(
        n, k_frames, n_members, n_class)
    e = torch.exp(torch.clamp_max(
        logits - logits.mean(dim=-1, keepdim=True), 85.0))
    probs = e / e.sum(dim=-1, keepdim=True)
    consensus = probs.sum(dim=1).sum(dim=1)
    return torch.where(mask, shannon_entropy(consensus), float("-inf"))


def validate(x, w_packed, b_packed, mask, n_members: int) -> None:
    """Raise ``ValueError`` on inputs the kernel does not take."""
    if x.dim() != 3 or w_packed.dim() != 2:
        raise ValueError(f"x must be (N, K, F) and w_packed (F, M*C); got "
                         f"{tuple(x.shape)} and {tuple(w_packed.shape)}")
    n, _, n_feat = x.shape
    mc = w_packed.shape[1]
    if (n_members <= 0 or w_packed.shape[0] != n_feat or mc % n_members
            or tuple(b_packed.shape) != (mc,) or min(x.shape) == 0):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w_packed.shape)}, b {tuple(b_packed.shape)}, "
                         f"M={n_members}")
    k_frames, n_class = x.shape[1], mc // n_members
    if (k_frames > MAX_FRAMES or mc > MAX_MEMBER_COLUMNS
            or n_class > MAX_CLASSES):
        raise ValueError(f"the kernel takes K <= {MAX_FRAMES} frames, "
                         f"M*C <= {MAX_MEMBER_COLUMNS} and C <= "
                         f"{MAX_CLASSES}; got K={k_frames}, M*C={mc}, "
                         f"C={n_class}")
    if smem_bytes(n_feat, mc) > SMEM_LIMIT:
        raise ValueError(f"W of F={n_feat} x M*C={mc} does not fit shared "
                         f"memory as TF32 hi and lo: the kernel needs "
                         f"{smem_bytes(n_feat, mc)} B of {SMEM_LIMIT}")
    if tuple(mask.shape) != (n,) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({n},); got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for name, t in (("x", x), ("w_packed", w_packed), ("b_packed", b_packed)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("w_packed", w_packed), ("b_packed", b_packed),
                    ("mask", mask)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("linear_mc")
    lib.linear_mc_launch.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.linear_mc_launch.restype = ctypes.c_int
    lib.linear_mc_error_string.argtypes = [ctypes.c_int]
    lib.linear_mc_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, w_packed, b_packed, mask, n_members: int, n_cand: int):
    """Launch the kernel on the current stream; returns ``(entropy,
    cand_values, cand_indices)`` with the candidates ``(n_tiles, n_cand)``
    in tile order."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the linear_mc kernel runs on CUDA tensors, got "
                         f"{x.device}")
    n, k_frames, n_feat = x.shape
    n_class = w_packed.shape[1] // n_members
    lib = _library()
    n_tiles = -(-n // TILE_SONGS)
    ent = torch.empty(n, dtype=torch.float32, device=x.device)
    cand_v = torch.empty((n_tiles, n_cand), dtype=torch.float32,
                         device=x.device)
    cand_i = torch.empty((n_tiles, n_cand), dtype=torch.int64,
                         device=x.device)
    with torch.cuda.device(x.device):
        err = lib.linear_mc_launch(
            x.data_ptr(), w_packed.data_ptr(), b_packed.data_ptr(),
            mask.data_ptr(), ent.data_ptr(), cand_v.data_ptr(),
            cand_i.data_ptr(), n, k_frames, n_feat, n_members, n_class,
            TILE_SONGS, n_cand, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"linear_mc launch failed: "
                           f"{lib.linear_mc_error_string(err).decode()}")
    launches += 1
    return ent, cand_v, cand_i


def linear_score_mc(x: torch.Tensor, w_packed: torch.Tensor,
                    b_packed: torch.Tensor, mask: torch.Tensor, *,
                    n_members: int, k: int, tie_break: str = "fast",
                    fuse_topk: bool = False):
    """Fused mc acquisition over the pool: ``(entropy, values, indices)``.

    ``x`` ``(N, K, F)`` float32, ``w_packed`` ``(F, M*C)``, ``b_packed``
    ``(M*C,)``, ``mask`` ``(N,)`` bool (False on already-queried songs).
    Entropy is ``-inf`` off the mask; ``'fast'`` ties go to the lowest index.
    With fewer than ``k`` valid rows, trailing values are ``-inf`` and their
    indices carry no meaning.  ``fuse_topk`` ranks inside the kernel (per-tile
    candidates, merged by a stable top-k; ``k <= MAX_FUSED_K``);
    ``tie_break='numpy'`` never takes that path.
    """
    validate(x, w_packed, b_packed, mask, n_members)
    fused = fuse_topk and tie_break == "fast"
    if fused and not 0 < k <= MAX_FUSED_K:
        raise ValueError(f"fused top-k takes 0 < k <= {MAX_FUSED_K}, got {k}")
    if x.device.type == "cpu":
        ent = plain_masked_entropy(x, w_packed, b_packed, mask, n_members)
        return (ent, *masked_top_k(ent, mask, k, tie_break))
    ent, cand_v, cand_i = _launch(x, w_packed, b_packed, mask, n_members,
                                  k if fused else 0)
    if not fused:
        return (ent, *masked_top_k(ent, mask, k, tie_break))
    flat_v = cand_v.reshape(-1)
    values, j = masked_top_k(flat_v, torch.ones_like(flat_v, dtype=torch.bool),
                             k, "fast")
    return ent, values, cand_i.reshape(-1)[j]


def linear_consensus_entropy(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Song-major ``(N, K, F)`` features and per-member ``(M, F, C)`` /
    ``(M, C)`` weights -> ``(N,)`` consensus entropy (no mask, no top-k)."""
    w_packed, b_packed = pack_weights(w, b)
    mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    validate(x, w_packed, b_packed, mask, w.shape[0])
    if x.device.type == "cpu":
        return plain_masked_entropy(x, w_packed, b_packed, mask, w.shape[0])
    return _launch(x, w_packed, b_packed, mask, w.shape[0], 0)[0]
