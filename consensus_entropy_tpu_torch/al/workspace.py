"""Per-user workspaces: private committee copies and crash resume.

Counterpart of ``consensus_entropy_tpu/al/workspace.py:34-183``.  Each user
gets ``{users_root}/{uid}/{mode}/`` holding a copy of every pretrained
member file (``amg_test.py:146-171``); a ``DONE`` marker, written last,
marks the user complete, and a partial directory whose ``al_state.json``
belongs to the same experiment resumes at its next iteration.

Member files are the port's (``classifier_{gnb,sgd,xgb,cnn}.{name}.npz``,
the ``xgb`` slot holding either boosted member,
``classifier_cnn_{arch}.{name}.npz`` from the pre-trainer, and the frozen
generic kinds' ``classifier_{rf,svc,knn,gpc,gbc}.{name}.npz``), loaded in
sorted file-name order, the order of JAX ``load_committee``
(``al/workspace.py:135-150``), so the committee's mean sums its members
in the same order.
A registry or workspace holding JAX files (scikit-learn and boosted-tree
pickles, ``.msgpack`` CNN checkpoints) raises an error naming them and
``convert.registry_from_jax``, which converts them: nothing is skipped
silently.
"""

from __future__ import annotations

import os
import shutil

from consensus_entropy_tpu_torch.config import CNNConfig, TrainConfig
from consensus_entropy_tpu_torch.models.committee import CNNMember, Committee
from consensus_entropy_tpu_torch.models.members import (
    MEMBER_TYPES,
    load_member,
)

_DONE = "DONE"
_MEMBER_PREFIX = "classifier_"


class UnportedMemberError(RuntimeError):
    """A committee file of a kind the port cannot load yet."""


#: the JAX pickles ``convert.registry_from_jax`` reads
_PICKLED = {"gnb": "GaussianNB", "sgd": "SGD", "xgb": "boosted-trees",
            "rf": "RandomForestClassifier", "svc": "SVC",
            "knn": "KNeighborsClassifier",
            "gpc": "GaussianProcessClassifier",
            "gbc": "GradientBoostingClassifier"}
_CONVERT = ("convert it with "
            "consensus_entropy_tpu_torch.convert.registry_from_jax")


def _member_kind(fname: str) -> str | None:
    """``gnb``/``sgd``/``xgb``/``cnn`` or a generic kind for the port's
    member files (``cnn`` for ``classifier_cnn_{arch}`` too), ``None`` for
    files that are not members; raises for member files the port cannot
    load."""
    if fname.endswith(".msgpack"):
        raise UnportedMemberError(
            f"{fname}: a JAX CNN checkpoint; {_CONVERT}")
    if not fname.startswith(_MEMBER_PREFIX):
        return None
    kind = fname[len(_MEMBER_PREFIX):].split(".")[0]
    if fname.endswith(".pkl"):
        if kind not in _PICKLED:
            raise UnportedMemberError(
                f"{fname}: a JAX {kind!r} member; it is not ported")
        raise UnportedMemberError(
            f"{fname}: a JAX {_PICKLED[kind]} pickle; {_CONVERT}")
    if fname.endswith(".npz"):
        if CNNMember.stem_of(fname) is not None:
            # the pre-trainer tags a non-vgg trunk's folds
            # ``classifier_cnn_{arch}``; the file's header names its trunk
            return CNNMember.kind
        if kind not in MEMBER_TYPES:
            raise UnportedMemberError(
                f"{fname}: no port member of kind {kind!r}")
        return kind
    return None


def member_files(directory: str) -> list[str]:
    """The port's member files in ``directory``, sorted; raises
    :class:`UnportedMemberError` on any member file it cannot load."""
    return [f for f in sorted(os.listdir(directory))
            if _member_kind(f) is not None]


class CheckpointCorruptError(RuntimeError):
    """A member file that exists but does not parse."""


def user_dir(users_root: str, user, mode: str) -> str:
    return os.path.join(users_root, str(user), mode)


def create_user(users_root: str, pretrained_dir: str, user, mode: str,
                experiment: dict | None = None):
    """Returns ``(path, skip)``; copies the pretrained committee on first
    creation.  A partial directory whose state matches ``experiment``
    (``{'seed', 'queries', 'train_size'}``) is kept for resume; any other
    partial directory is redone from the pretrained files."""
    from consensus_entropy_tpu_torch.al import state as al_state

    path = user_dir(users_root, user, mode)
    if os.path.exists(os.path.join(path, _DONE)):
        return path, True
    files = member_files(pretrained_dir)
    if os.path.isdir(path):
        st = al_state.ALState.load(path)
        resumable = st is not None and (experiment is None or st.matches(
            mode=mode, seed=experiment["seed"],
            queries=experiment["queries"],
            train_size=experiment["train_size"]))
        if resumable:
            al_state.recover_workspace(path)
            return path, False
        shutil.rmtree(path)  # pre-state crash or another experiment
    os.makedirs(path)
    for fname in files:
        shutil.copy(os.path.join(pretrained_dir, fname),
                    os.path.join(path, fname))
    return path, False


def mark_done(path: str) -> None:
    """The completion marker, through the durable-write seam."""
    from consensus_entropy_tpu_torch.resilience import io as dio

    dio.atomic_write(os.path.join(path, _DONE), b"ok\n",
                     member="workspace")


def load_committee(path: str, config: CNNConfig = CNNConfig(),
                   train_config: TrainConfig = TrainConfig(), *,
                   device_members: bool = False,
                   full_song_hop: int | None = None,
                   device=None, mesh=None, train_mesh=None) -> Committee:
    """Load every member file of a workspace into a ``Committee`` (CNN
    members under ``config``, honouring their files' frontend; scoring
    full songs with ``full_song_hop``; on ``device``, by default the pool
    ``mesh``'s first device when there is one, sharding the CNN forward
    over ``mesh`` and the retrain over ``train_mesh``), after
    finishing or discarding a torn checkpoint.  A member file that fails to
    parse rolls the workspace back one generation once (the last-good
    snapshot) and loads again; without a snapshot the error propagates."""
    from consensus_entropy_tpu_torch.al.state import (
        recover_workspace,
        rollback_workspace,
    )

    if device is None and mesh is not None:
        device = mesh.device_list[0]
    meshes = {"mesh": mesh, "train_mesh": train_mesh}
    recover_workspace(path)
    try:
        return _load_committee_once(path, config, train_config,
                                    device_members, full_song_hop, device,
                                    meshes)
    except CheckpointCorruptError as e:
        if not rollback_workspace(path):
            raise
        import warnings

        warnings.warn(f"{path}: corrupt live checkpoint ({e}); rolled back "
                      "to the previous generation - one AL iteration will "
                      "be replayed")
        return _load_committee_once(path, config, train_config,
                                    device_members, full_song_hop, device,
                                    meshes)


def _load_committee_once(path: str, config, train_config,
                         device_members: bool, full_song_hop, device,
                         meshes: dict) -> Committee:
    members, cnns = [], []
    for fname in member_files(path):
        full = os.path.join(path, fname)
        kind = _member_kind(fname)
        try:
            if kind == CNNMember.kind:
                cnns.append(CNNMember.load(full, config, device))
            else:
                members.append(load_member(kind, full))
        except Exception as e:
            raise CheckpointCorruptError(
                f"{full}: failed to load member file ({e!r})") from e
    if not members and not cnns:
        raise FileNotFoundError(f"no committee members in {path}")
    return Committee(members, cnns, config, train_config,
                     device_members=device_members,
                     full_song_hop=full_song_hop, device=device, **meshes)
