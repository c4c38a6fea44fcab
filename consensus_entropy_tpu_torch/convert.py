"""Carry committee weights, PRNG keys, fitted host members, CNN members,
user workspaces and pretrained registries from the JAX package's layouts
to the port's.

Inputs are array-likes (numpy arrays, or JAX arrays, which ``np.asarray``
reads without this module importing JAX), the JAX package's pickles of
fitted scikit-learn estimators and boosted trees, read by attribute, and
its ``CETPU1`` CNN checkpoints, whose msgpack payload a small reader here
decodes (no msgpack or Flax import), and the reference's own
ShortChunkCNN ``state_dict``s.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

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


def _gbdt_from_jax(member):
    """A JAX ``NativeGBDTMember`` -> the port's, read by attribute."""
    from consensus_entropy_tpu_torch.models.gbdt import NativeGBDTMember

    return NativeGBDTMember.from_state({
        "name": member.name, "n_estimators": member.n_estimators,
        "update_estimators": member.update_estimators,
        "n_bins": member.binner.n_bins, "edges": member.binner.edges,
        "model": member.model.state()})


#: the scikit-learn estimator of each generic kind, by class name
GENERIC_ESTIMATORS = {"RandomForestClassifier": "rf", "SVC": "svc",
                      "KNeighborsClassifier": "knn",
                      "GaussianProcessClassifier": "gpc",
                      "GradientBoostingClassifier": "gbc"}


def _knn_state(est) -> dict:
    if est.weights != "uniform" or est.metric not in ("minkowski",
                                                      "euclidean") or (
            est.metric == "minkowski" and est.p != 2):
        raise ValueError("KNeighborsClassifier: only uniform weights and "
                         "the Euclidean metric are ported")
    return {"fit_X": np.array(est._fit_X, copy=True),
            "y": np.asarray(est._y, np.intp).copy(),
            "classes": np.asarray(est.classes_).copy(),
            "n_neighbors": int(est.n_neighbors)}


def _rf_state(est) -> dict:
    from consensus_entropy_tpu_torch.models.generic_members import (
        _tree_arrays,
    )

    if est.n_outputs_ != 1:
        raise ValueError("RandomForestClassifier: multi-output forests are "
                         "not ported")
    return {"classes": np.asarray(est.classes_).copy(),
            **_tree_arrays([t.tree_ for t in est.estimators_])}


def _gbc_state(est) -> dict:
    from consensus_entropy_tpu_torch.models.generic_members import (
        _tree_arrays,
    )

    stages = np.asarray(est.estimators_)
    if stages.ndim != 2 or stages.shape[1] < 3:
        raise ValueError("GradientBoostingClassifier: only the multi-class "
                         "(3 or more classes) model is ported")
    if est.init_ == "zero" or type(est.init_).__name__ != "DummyClassifier" \
            or est.init_.strategy != "prior":
        raise ValueError("GradientBoostingClassifier: only the default "
                         "prior init_ is ported")
    # the prior's link is the same for every row: take it from one
    probe = np.zeros((1, est.n_features_in_), np.float32)
    init_raw = np.asarray(est._raw_predict_init(probe), np.float64)[0]
    return {"classes": np.asarray(est.classes_).copy(),
            "init_raw": init_raw.copy(),
            "learning_rate": float(est.learning_rate),
            **_tree_arrays([t.tree_ for t in stages.ravel()])}


def _svc_state(est) -> dict:
    if est.kernel != "rbf" or not est.probability or est.break_ties:
        raise ValueError("SVC: only the RBF kernel with probability=True "
                         "and break_ties=False is ported")
    return {"classes": np.asarray(est.classes_).copy(),
            "support_vectors": np.array(est.support_vectors_, np.float64),
            "dual_coef": np.array(est._dual_coef_, np.float64),
            "intercept": np.array(est._intercept_, np.float64),
            "n_support": np.asarray(est._n_support, np.int64).copy(),
            "prob_a": np.array(est._probA, np.float64),
            "prob_b": np.array(est._probB, np.float64),
            "gamma": float(est._gamma)}


def _gpc_state(est) -> dict:
    binaries = getattr(est.base_estimator_, "estimators_", None)
    if binaries is None or len(binaries) < 3:
        raise ValueError("GaussianProcessClassifier: only the one-vs-rest "
                         "multi-class model is ported")
    x_train = np.array(binaries[0].X_train_, copy=True)
    const, scale = [], []
    for b in binaries:
        k = b.kernel_
        if (type(k).__name__ != "Product"
                or type(k.k1).__name__ != "ConstantKernel"
                or type(k.k2).__name__ != "RBF"
                or np.ndim(k.k2.length_scale) != 0):
            raise ValueError(f"GaussianProcessClassifier: kernel {k} is not "
                             "ported (the member implements C * RBF(l))")
        if not np.array_equal(b.X_train_, x_train):
            raise ValueError("GaussianProcessClassifier: the binary "
                             "estimators' training rows differ")
        const.append(float(k.k1.constant_value))
        scale.append(float(k.k2.length_scale))
    return {"classes": np.asarray(est.classes_).copy(), "x_train": x_train,
            "y_train": np.stack([np.asarray(b.y_train_)
                                 for b in binaries]),
            "pi": np.stack([np.asarray(b.pi_, np.float64)
                            for b in binaries]),
            "w_sr": np.stack([np.asarray(b.W_sr_, np.float64)
                              for b in binaries]),
            "L": np.stack([np.asarray(b.L_, np.float64) for b in binaries]),
            "constant": np.asarray(const, np.float64),
            "length_scale": np.asarray(scale, np.float64)}


_GENERIC_STATE = {"knn": _knn_state, "rf": _rf_state, "gbc": _gbc_state,
                  "svc": _svc_state, "gpc": _gpc_state}


def generic_from_estimator(name: str, kind: str, est):
    """A fitted scikit-learn estimator of a generic kind (``rf``, ``svc``,
    ``knn``, ``gpc``, ``gbc``) -> the port's ``GenericMember`` holding its
    fitted arrays, read by attribute."""
    from consensus_entropy_tpu_torch.models.generic_members import (
        GenericMember,
    )

    want = GENERIC_ESTIMATORS.get(type(est).__name__)
    if want != kind:
        raise ValueError(f"{name}: a {type(est).__name__} is not a "
                         f"{kind!r} member")
    return GenericMember(name, kind, _GENERIC_STATE[kind](est))


def _from_estimator(name: str, est, kind: str | None = None):
    if hasattr(est, "theta_") and hasattr(est, "var_smoothing"):
        return _gnb_from_estimator(name, est)
    if hasattr(est, "coef_") and getattr(est, "loss", None):
        return _sgd_from_estimator(name, est)
    kind = kind or GENERIC_ESTIMATORS.get(type(est).__name__)
    if kind is not None:
        return generic_from_estimator(name, kind, est)
    raise ValueError(f"{name}: {type(est).__name__} is not a fitted "
                     "GaussianNB, SGDClassifier or generic-kind estimator")


def boosted_from_jax(name: str, est, update_estimators: int,
                     class_rows: dict):
    """The JAX boosted slot's scikit-learn member (``BoostedTreesMember``:
    a ``GradientBoostingClassifier`` with warm start, its update size and
    its remembered row of each class) -> the port's, read by attribute,
    the estimator's random state included."""
    from consensus_entropy_tpu_torch.models.members import (
        BoostedTreesMember,
    )
    from consensus_entropy_tpu_torch.models.tree_fit import TREE_KEYS

    if type(est).__name__ != "GradientBoostingClassifier":
        raise ValueError(f"{name}: a {type(est).__name__} is not the "
                         "boosted slot's GradientBoostingClassifier")
    if (est.subsample != 1.0 or est.max_features is not None
            or est.max_leaf_nodes is not None or est.min_samples_split != 2
            or est.min_samples_leaf != 1 or est.n_iter_no_change is not None
            or est.init is not None or est.loss != "log_loss"):
        raise ValueError(f"{name}: only the boosted slot's "
                         "GradientBoostingClassifier settings are ported")
    st = {"name": name, "max_depth": int(est.max_depth),
          "n_estimators": int(est.n_estimators),
          "learning_rate": float(est.learning_rate),
          "update_estimators": int(update_estimators),
          "random_state": est.random_state,
          "class_rows": {int(c): np.array(r, copy=True)
                         for c, r in class_rows.items()}}
    if hasattr(est, "estimators_"):
        g = _gbc_state(est)
        st.update(classes=g["classes"], init_raw=g["init_raw"],
                  trees={k: g[k] for k in TREE_KEYS},
                  rng_state=est._rng.get_state())
    return BoostedTreesMember.from_state(st)


def host_members_from_jax(members) -> list:
    """The JAX package's host members (``GNBMember``, ``SGDMember``,
    ``GenericSklearnMember`` or their fitted scikit-learn estimators,
    ``NativeGBDTMember`` and ``BoostedTreesMember``, read by attribute) ->
    the port's members with the same fitted state."""
    out = []
    for i, m in enumerate(members):
        if hasattr(m, "binner"):
            out.append(_gbdt_from_jax(m))
        elif hasattr(m, "update_estimators"):
            out.append(boosted_from_jax(m.name, m.estimator,
                                        m.update_estimators,
                                        getattr(m, "_class_rows", {})))
        else:
            out.append(_from_estimator(getattr(m, "name", f"member_{i}"),
                                       getattr(m, "estimator", m),
                                       getattr(m, "kind", None)))
    return out


def _member_from_pickle(path: str):
    """One JAX member pickle (``{"kind", "name", "estimator"}``: GaussianNB,
    SGD or a generic kind; the boosted slot's native GBDT or its
    GradientBoosting member) -> the port's member."""
    import pickle

    from consensus_entropy_tpu_torch.models.gbdt import NativeGBDTMember

    with open(path, "rb") as f:
        state = pickle.load(f)
    if state.get("fmt") == "native_gbdt":
        return NativeGBDTMember.from_state(state)
    from consensus_entropy_tpu_torch.models.generic_members import (
        GENERIC_KINDS,
    )

    kind = state.get("kind")
    if kind == "xgb" and "update_estimators" in state \
            and "estimator" in state:
        return boosted_from_jax(state["name"], state["estimator"],
                                state["update_estimators"],
                                state.get("class_rows", {}))
    if kind not in ("gnb", "sgd", *GENERIC_KINDS) or "estimator" not in state:
        raise ValueError(f"{path}: a {kind!r} member pickle whose format "
                         "is not ported (the port reads GaussianNB, SGD, "
                         "the generic kinds and both boosted members; an "
                         "xgboost booster has no counterpart)")
    if kind in GENERIC_KINDS:
        return generic_from_estimator(state["name"], kind,
                                      state["estimator"])
    return _from_estimator(state["name"], state["estimator"])


def _convert_members(src: str, dst: str, config=None) -> list[str]:
    """Write the port's file for every ``classifier_*.pkl`` and
    ``classifier_cnn*.msgpack`` in ``src`` into ``dst``, CNN members
    (geometry ``config``, default ``CNNConfig()``) in float32, each under
    the name its committee checkpoints it by (a CNN member keeps its
    source's stem, ``cnn_res`` or ``cnn``)."""
    from consensus_entropy_tpu_torch.models.committee import Committee

    written = []
    for fname in sorted(os.listdir(src)):
        if not fname.startswith("classifier_"):
            continue
        if fname.endswith(".msgpack"):
            member = cnn_member_from_jax(os.path.join(src, fname), config)
        elif fname.endswith(".pkl"):
            member = _member_from_pickle(os.path.join(src, fname))
        else:
            continue
        out = Committee.member_file(member)
        member.save(os.path.join(dst, out))
        written.append(out)
    return written


def registry_from_jax(pretrained_dir: str, out: str,
                      config=None) -> list[str]:
    """A JAX pretrained registry (``classifier_{gnb,sgd,xgb}.*.pkl``, the
    generic kinds' ``classifier_{rf,svc,knn,gpc,gbc}.*.pkl``,
    ``classifier_cnn.*.msgpack`` of geometry ``config``) -> the port's
    member files in ``out``; returns their names."""
    os.makedirs(out, exist_ok=True)
    return _convert_members(pretrained_dir, out, config)


def workspace_from_jax(src: str, dst: str, config=None) -> list[str]:
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
    return copied + _convert_members(src, dst, config)


# -- CNN members ------------------------------------------------------------


def cnn_variables_from_jax(variables, config=None, device=None) -> dict:
    """A Flax ShortChunkCNN's ``{"params", "batch_stats"}`` (arrays or
    nested dicts of them, as ``flax.serialization`` restores them) -> the
    port's variables (``models.short_cnn.variable_shapes`` names, every
    trunk family), float32 on ``device``: each layer read at its Flax path
    (``short_cnn.layers``), kernels ``(*spatial, in, out)`` -> ``(out, in,
    *spatial)``, BatchNorm ``scale``/``bias``/``mean``/``var`` ->
    ``weight``/``bias``/``running_mean``/``running_var``."""
    from consensus_entropy_tpu_torch.config import CNNConfig
    from consensus_entropy_tpu_torch.models import short_cnn

    config = CNNConfig() if config is None else config
    params, stats = variables["params"], variables["batch_stats"]

    def at(tree, path):
        for name in path:
            tree = tree[name]
        return np.asarray(tree, np.float32)

    out = {}
    for layer in short_cnn.layers(config):
        p = layer.path
        if layer.kind == "param":
            out[layer.name] = at(params, p)
        elif layer.kind == "bn":
            for ours, (tree, leaf) in zip(short_cnn.BN_FIELDS, (
                    (params, "scale"), (params, "bias"), (stats, "mean"),
                    (stats, "var"))):
                out[f"{layer.name}.{ours}"] = at(tree, p + (leaf,))
        else:
            out[f"{layer.name}.weight"] = short_cnn.kernel_from_flax(
                at(params, p + ("kernel",)))
            out[f"{layer.name}.bias"] = at(params, p + ("bias",))
    return _checked(out, config, device)


def _checked(arrays: dict, config, device) -> dict:
    """``arrays`` as float32 tensors on ``device`` in
    ``short_cnn.variable_shapes`` order; raises unless the names and
    shapes are those of ``config``."""
    from consensus_entropy_tpu_torch.models.short_cnn import variable_shapes

    shapes = variable_shapes(config)
    got = {k: tuple(v.shape) for k, v in arrays.items()}
    if got != shapes:
        raise ValueError(f"the variables do not fit {config}: "
                         f"{sorted(set(got.items()) ^ set(shapes.items()))}")
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(arrays[k], np.float32)).to(dev)
            for k in shapes}


def cnn_variables_from_reference(state, config=None, device=None) -> dict:
    """The reference's ShortChunkCNN ``state_dict`` (torch tensors or
    arrays: ``spec_bn``, ``layer{i}.conv``/``layer{i}.bn``, ``dense1``,
    ``bn``, ``dense2``) -> the port's vgg variables on ``device``, names
    mapped and no transpose (both are torch layouts); the counterpart of
    JAX ``utils/torch_import.py::import_torch_shortchunk``, with its
    checks.  The ``spec.*`` buffers (the mel filterbank the reference
    ships) are dropped: the port computes it from the config, and its
    shape must match the config's mel geometry; ``num_batches_tracked``
    has no counterpart."""
    from consensus_entropy_tpu_torch.config import CNNConfig
    from consensus_entropy_tpu_torch.models.short_cnn import variable_shapes

    config = CNNConfig() if config is None else config
    if config.arch != "vgg":
        raise ValueError("reference checkpoints are the vgg ShortChunkCNN; "
                         f"config.arch is {config.arch!r}")

    def arr(t):
        return np.asarray(t.detach().cpu().numpy()
                          if isinstance(t, torch.Tensor) else t, np.float32)

    layers = sorted({int(k.split(".")[0][5:]) for k in state
                     if k.startswith("layer")})
    if layers != list(range(1, config.n_layers + 1)):
        raise ValueError(f"checkpoint has conv layers {layers}; config "
                         f"expects 1..{config.n_layers}")
    fb = state.get("spec.mel_scale.fb")
    if fb is not None:
        want = (config.n_fft // 2 + 1, config.n_mels)
        if tuple(fb.shape) != want:
            raise ValueError(
                f"checkpoint mel filterbank is {tuple(fb.shape)}; config "
                f"(n_fft={config.n_fft}, n_mels={config.n_mels}) expects "
                f"{want}")
    names = {"spec_bn": "spec_bn", "dense1": "dense1", "head_bn": "bn",
             "dense2": "dense2"}
    for i, width in enumerate(config.channel_widths):
        kernel = state[f"layer{i + 1}.conv.weight"]
        if kernel.shape[0] != width:
            raise ValueError(
                f"layer{i + 1} has {kernel.shape[0]} output channels; "
                f"config expects {width} (n_channels={config.n_channels})")
        names[f"blocks.{i}.conv"] = f"layer{i + 1}.conv"
        names[f"blocks.{i}.bn"] = f"layer{i + 1}.bn"
    n_class = state["dense2.bias"].shape[0]
    if n_class != config.n_class:
        raise ValueError(f"checkpoint head has {n_class} classes; config "
                         f"expects {config.n_class}")
    out = {}
    for name in variable_shapes(config):
        prefix, field = name.rsplit(".", 1)
        out[name] = arr(state[f"{names[prefix]}.{field}"])
    return _checked(out, config, device)


_CETPU_MAGIC = b"CETPU1\n"


class _MsgpackReader:
    """The msgpack subset ``flax.serialization.to_bytes`` writes: maps,
    arrays, strings, binaries, numbers, nil, booleans and extension types
    (Flax's ndarray, ext code 1, and numpy scalar, ext code 3)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def _take(self, n: int) -> bytes:
        out = self.data[self.pos: self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack payload")
        self.pos += n
        return out

    def _num(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
                 0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
                 0xDC: ("arr", "H"), 0xDD: ("arr", "I"),
                 0xDE: ("map", "H"), 0xDF: ("map", "I"),
                 0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I")}
        nums = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in nums:
            return self._num(nums[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(1 << (b - 0xD4))
        if b not in sized:
            raise ValueError(f"unsupported msgpack type byte {b:#x}")
        kind, fmt = sized[b]
        n = self._num(fmt)
        if kind == "bin":
            return self._take(n)
        if kind == "str":
            return self._take(n).decode("utf-8")
        if kind == "arr":
            return [self.read() for _ in range(n)]
        if kind == "map":
            return self._map(n)
        return self._ext(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self._num("b")
        body = self._take(n)
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack extension {code}")
        shape, dtype, buf = _MsgpackReader(body).read()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            # the top half of a float32's bits
            bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(dtype)).copy()
        return arr.reshape(shape)


def read_cetpu_checkpoint(path: str) -> tuple[dict, dict]:
    """A JAX ``utils/checkpoint.py`` file (``:35-90``): the ``CETPU1``
    magic, the header length and JSON (CRC32 of the payload checked when
    present), then Flax's msgpack payload.  Returns ``(variables, meta)``,
    the variables as nested dicts of numpy arrays, bfloat16 leaves as
    float32."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(_CETPU_MAGIC):
        raise ValueError(f"{path}: not a CETPU1 checkpoint")
    at = len(_CETPU_MAGIC)
    if len(raw) < at + 4:
        raise ValueError(f"{path}: truncated header")
    (hlen,) = struct.unpack("<I", raw[at: at + 4])
    header = raw[at + 4: at + 4 + hlen]
    if len(header) != hlen:
        raise ValueError(f"{path}: truncated header")
    meta = json.loads(header.decode())
    payload = raw[at + 4 + hlen:]
    crc = meta.get("crc32")
    if crc is not None and zlib.crc32(payload) != crc:
        raise ValueError(f"{path}: payload CRC mismatch (expected {crc}, "
                         f"got {zlib.crc32(payload)})")
    return _MsgpackReader(payload).read(), meta


def cnn_member_from_jax(path: str, config=None, device="cpu"):
    """A JAX ``classifier_cnn*.msgpack`` member -> the port's
    ``CNNMember`` (float32 variables on ``device``), its frontend fields
    taken from the file's header as the JAX loader does, its file stem
    from the file's name."""
    import dataclasses

    from consensus_entropy_tpu_torch.config import CNNConfig
    from consensus_entropy_tpu_torch.models.committee import CNNMember

    variables, meta = read_cetpu_checkpoint(path)
    config = CNNConfig() if config is None else config
    override = {k: meta[k] for k in CNNMember.FRONTEND_META
                if k in meta and meta[k] != getattr(config, k)}
    if override:
        config = dataclasses.replace(config, **override)
    name = meta.get("name", os.path.basename(path))
    return CNNMember(name, cnn_variables_from_jax(variables, config, device),
                     config, CNNMember.stem_of(path))
