"""Carry committee weights, PRNG keys, fitted host members, user
workspaces and pretrained registries from the JAX package's layouts to the
port's.

Inputs are array-likes (numpy arrays, or JAX arrays, which ``np.asarray``
reads without this module importing JAX) and, for the host members, the
JAX package's pickles of fitted scikit-learn estimators, read by attribute.
"""

from __future__ import annotations

import os

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


# -- host members, workspaces and registries ------------------------------
#
# These read the JAX package's pickled scikit-learn estimators, so they run
# only where scikit-learn is installed; this module imports none of it.


def _gnb_from_estimator(name: str, est):
    from consensus_entropy_tpu_torch.models.members import GNBMember

    if getattr(est, "priors", None) is not None:
        raise ValueError(f"{name}: GaussianNB with fixed priors is not "
                         "ported")
    m = GNBMember(name, var_smoothing=float(est.var_smoothing))
    m.classes_ = np.asarray(est.classes_).copy()
    m.theta_ = np.asarray(est.theta_).copy()
    m.var_ = np.asarray(est.var_).copy()
    m.class_count_ = np.asarray(est.class_count_).copy()
    m.class_prior_ = np.asarray(est.class_prior_).copy()
    m.epsilon_ = est.epsilon_
    return m


#: the SGDClassifier settings the port's member implements
_SGD_SETTINGS = {"loss": "log_loss", "penalty": "l2",
                 "learning_rate": "optimal", "fit_intercept": True,
                 "average": False, "early_stopping": False,
                 "class_weight": None}


def _sgd_from_estimator(name: str, est):
    from consensus_entropy_tpu_torch.models.members import SGDMember

    for attr, want in _SGD_SETTINGS.items():
        if getattr(est, attr) != want:
            raise ValueError(f"{name}: SGDClassifier {attr}="
                             f"{getattr(est, attr)!r} is not ported "
                             f"(the member implements {attr}={want!r})")
    rs = est.random_state
    if rs is not None and not isinstance(rs, (int, np.integer)):
        raise ValueError(f"{name}: a RandomState instance as random_state "
                         "cannot be carried across")
    m = SGDMember(name, seed=None if rs is None else int(rs),
                  alpha=float(est.alpha), max_iter=int(est.max_iter),
                  tol=None if est.tol is None else float(est.tol),
                  n_iter_no_change=int(est.n_iter_no_change),
                  shuffle=bool(est.shuffle))
    m.classes_ = np.asarray(est.classes_).copy()
    m.coef_ = np.asarray(est.coef_).copy()
    m.intercept_ = np.asarray(est.intercept_).copy()
    m.t_ = float(est.t_)
    m.n_iter_ = getattr(est, "n_iter_", None)
    if m.n_iter_ is not None:
        m.n_iter_ = int(m.n_iter_)
    return m


def _from_estimator(name: str, est):
    if hasattr(est, "theta_") and hasattr(est, "var_smoothing"):
        return _gnb_from_estimator(name, est)
    if hasattr(est, "coef_") and getattr(est, "loss", None):
        return _sgd_from_estimator(name, est)
    raise ValueError(f"{name}: {type(est).__name__} is not a fitted "
                     "GaussianNB or SGDClassifier")


def host_members_from_jax(members) -> list:
    """The JAX package's GaussianNB / SGD members (``GNBMember``,
    ``SGDMember``, or their fitted scikit-learn estimators, read by
    attribute) -> the port's members with the same fitted state."""
    return [_from_estimator(getattr(m, "name", f"member_{i}"),
                            getattr(m, "estimator", m))
            for i, m in enumerate(members)]


def _member_from_pickle(path: str):
    """One JAX member pickle (``{"kind", "name", "estimator"}``) -> the
    port's member."""
    import pickle

    with open(path, "rb") as f:
        state = pickle.load(f)
    if state.get("kind") not in ("gnb", "sgd") or "estimator" not in state:
        raise ValueError(f"{path}: a {state.get('kind')!r} member, not a "
                         "GaussianNB / SGD pickle; it is not ported")
    return _from_estimator(state["name"], state["estimator"])


def _convert_members(src: str, dst: str) -> list[str]:
    """Write the port's file for every ``classifier_*.pkl`` in ``src``
    into ``dst``; any other committee file is refused by name."""
    from consensus_entropy_tpu_torch.models.committee import Committee

    written = []
    for fname in sorted(os.listdir(src)):
        if fname.endswith(".msgpack"):
            raise ValueError(f"{fname}: CNN committee members are not "
                             "ported yet (ROADMAP A7)")
        if not (fname.startswith("classifier_") and fname.endswith(".pkl")):
            continue
        member = _member_from_pickle(os.path.join(src, fname))
        out = Committee.member_file(member)
        member.save(os.path.join(dst, out))
        written.append(out)
    return written


def registry_from_jax(pretrained_dir: str, out: str) -> list[str]:
    """A JAX pretrained registry (``classifier_{gnb,sgd}.*.pkl``) -> the
    port's member files in ``out``; returns their names."""
    os.makedirs(out, exist_ok=True)
    return _convert_members(pretrained_dir, out)


def workspace_from_jax(src: str, dst: str) -> list[str]:
    """A JAX user workspace -> the port's: ``al_state.json`` (and its
    previous generation) copied as is, member pickles converted, reports
    and metrics copied.  A workspace with a torn checkpoint (a staging
    directory) must be recovered by the JAX package first."""
    import shutil

    names = os.listdir(src)
    torn = [n for n in names if n.startswith("_staged_gen")]
    if torn:
        raise ValueError(f"{src} holds a torn checkpoint {torn}; recover "
                         "it (al.state.recover_workspace) first")
    os.makedirs(dst, exist_ok=True)
    copied = []
    for fname in sorted(names):
        if (fname in ("al_state.json", "al_state.json.prev", "DONE",
                      "metrics.jsonl", "timings.jsonl")
                or fname.endswith(".txt")):
            shutil.copyfile(os.path.join(src, fname),
                            os.path.join(dst, fname))
            copied.append(fname)
    return copied + _convert_members(src, dst)
