"""Carry committee weights and PRNG keys from the JAX package's layouts to
the port's.

Inputs are array-likes (numpy arrays, or JAX arrays, which ``np.asarray``
reads without this module importing JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.device import resolve_device
from consensus_entropy_tpu_torch.kernels.linear_mc import pack_weights
from consensus_entropy_tpu_torch.ops.device_members import MemberStacks


def linear_members_from_jax(w, b, device=None):
    """Per-member ``(M, F, C)`` weights / ``(M, C)`` biases — the layout
    ``bench.py::make_inputs`` and JAX ``pack_weights`` take — -> the port's
    packed ``(F, M*C)`` / ``(M*C,)`` float32 tensors on ``device``."""
    w = torch.as_tensor(np.asarray(w, np.float32))
    b = torch.as_tensor(np.asarray(b, np.float32))
    if w.dim() != 3 or tuple(b.shape) != (w.shape[0], w.shape[2]):
        raise ValueError(f"expected w (M, F, C) and b (M, C); got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    w_packed, b_packed = pack_weights(w, b)
    dev = resolve_device(device)
    return w_packed.to(dev), b_packed.to(dev)


def from_jax_packed(w_packed, b_packed, pack: int, n_members: int,
                    device=None):
    """Undo JAX ``pack_weights(w, b, pack=P)``.

    That call replicates the ``(F, M*C)`` matrix ``P`` times along a block
    diagonal of ``(P*F, P*M*C)`` and tiles the bias to ``(P*M*C,)``;
    ``n_members`` is the ``P*M`` the JAX scorer is given.  Returns the
    port's ``(F, M*C)`` / ``(M*C,)`` tensors and ``M``.  Raises when the
    input is not such a replica.
    """
    w = np.asarray(w_packed, np.float32)
    b = np.asarray(b_packed, np.float32)
    if (pack < 1 or n_members % pack or w.ndim != 2 or w.shape[0] % pack
            or w.shape[1] % pack or b.shape != (w.shape[1],)):
        raise ValueError(f"shape mismatch: w {w.shape}, b {b.shape}, "
                         f"pack={pack}, n_members={n_members}")
    f, mc = w.shape[0] // pack, w.shape[1] // pack
    block = w[:f, :mc]
    replica = np.zeros_like(w)
    for p in range(pack):
        replica[p * f:(p + 1) * f, p * mc:(p + 1) * mc] = block
    if not (np.array_equal(w, replica)
            and np.array_equal(b, np.tile(b[:mc], pack))):
        raise ValueError(f"not a pack={pack} block-diagonal replica")
    dev = resolve_device(device)
    return (torch.from_numpy(block.copy()).to(dev),
            torch.from_numpy(b[:mc].copy()).to(dev), n_members // pack)


def device_members_from_numpy(gnb_theta, gnb_var, gnb_log_prior, sgd_coef,
                              sgd_intercept, device=None) -> MemberStacks:
    """The closed-form members' stacked parameters -> the port's float32
    :class:`MemberStacks` on ``device``.

    The arrays are those the JAX ``Committee._device_member_probs`` stacks
    from fitted estimators (``models/committee.py:900-912``): per
    GaussianNB member ``theta_``, ``var_`` and ``log(class_prior_)``, per
    SGD-logistic member ``coef_`` and ``intercept_``.  Shapes ``(G, C, F)``
    twice, ``(G, C)``, ``(S, C, F)``, ``(S, C)``; ``G`` or ``S`` may be 0.
    """
    arrays = [np.asarray(a, np.float32) for a in
              (gnb_theta, gnb_var, gnb_log_prior, sgd_coef, sgd_intercept)]
    theta, coef = arrays[0], arrays[3]
    g, c, f = theta.shape if theta.ndim == 3 else (None,) * 3
    s = coef.shape[0] if coef.ndim else None
    want = [(g, c, f), (g, c, f), (g, c), (s, c, f), (s, c)]
    if [a.shape for a in arrays] != want:
        raise ValueError("expected (G, C, F) theta and var, (G, C) log "
                         "prior, (S, C, F) coef and (S, C) intercept; got "
                         f"{[a.shape for a in arrays]}")
    dev = resolve_device(device)
    return MemberStacks(*(torch.from_numpy(a.copy()).to(dev)
                          for a in arrays))


def key_from_jax(key_data, device=None) -> torch.Tensor:
    """A JAX threefry key's ``(2,)`` uint32 data (``jax.random.key_data``,
    or the nested list ``ALState`` persists) -> the port's key."""
    words = np.asarray(key_data)
    if words.shape != (2,) or words.min() < 0 or words.max() > 0xFFFFFFFF:
        raise ValueError(f"expected two uint32 words, got {words!r}")
    return prng.wrap_key_data(words, device)
