"""Shared checks of one CNN trunk family of the port against the JAX
package's, on the CPU (``tests/test_torch_cnn_{res,harm,se1d,musicnn}.py``).

Two JAX-initialized members (the second with moved BatchNorm statistics)
are carried across by ``convert.cnn_variables_from_jax``; the same numpy
waveforms and keys go through both packages.  The tolerances are those of
``tests/test_torch_cnn.py`` (float32 convolutions summed in two orders:
sigmoid scores within atol 1e-5, features and BatchNorm statistics within
rtol 1e-4 / atol 1e-4) and ``tests/test_torch_cnn_trainer.py`` (losses
within rtol 1e-3 / atol 1e-4, weights within rtol 1e-3 / atol 2e-3 after
``fit_epochs``: one adam epoch, or two through the adam -> sgd transition
and its best reload).  A case may widen the train-mode score tolerance,
saying why."""

import jax
import numpy as np
import torch

from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.config import TrainConfig as JaxTrainConfig
from consensus_entropy_tpu.data.audio import DeviceWaveformStore as JaxStore
from consensus_entropy_tpu.models import cnn_trainer as jax_trainer
from consensus_entropy_tpu.models import short_cnn as jax_cnn
from consensus_entropy_tpu.models.committee import CNNMember as JaxMember
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu_torch import convert, prng
from consensus_entropy_tpu_torch.config import CNNConfig, TrainConfig
from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
from consensus_entropy_tpu_torch.labels import one_hot_np
from consensus_entropy_tpu_torch.models import cnn_trainer, short_cnn
from consensus_entropy_tpu_torch.models.committee import CNNMember, Committee

SCORE_TOL = {"rtol": 0, "atol": 1e-5}
FEAT_TOL = {"rtol": 1e-4, "atol": 1e-4}
LOSS_TOL = {"rtol": 1e-3, "atol": 1e-4}
WEIGHT_TOL = {"rtol": 1e-3, "atol": 2e-3}
#: one adam epoch, then sgd_1 after the best reload
TC_KW = dict(batch_size=4, adam_patience=1, sgd_patience=1)


class TrunkCase:
    """One trunk family at a tiny geometry, its JAX functions compiled
    once (their eager dispatch is the slow part)."""

    def __init__(self, arch: str, kw: dict, train_tol=SCORE_TOL,
                 fit_epochs: int = 1):
        self.cfg = CNNConfig(arch=arch, **kw)
        self.jcfg = jc = JaxCNNConfig(arch=arch, **kw)
        self.train_tol = train_tol
        #: each schedule phase run compiles a JAX epoch program
        self.fit_epochs = fit_epochs
        self.init = jax.jit(lambda k: jax_cnn.init_variables(k, jc))
        self.infer = jax.jit(lambda v, x: jax_cnn.apply_infer(v, x, jc))
        self.features = jax.jit(
            lambda v, x: jax_cnn.apply_features(v, x, jc))
        self.train = jax.jit(
            lambda v, x, k: jax_cnn.apply_train(v, x, k, jc))
        self.qbdc = jax.jit(lambda v, x, k: jax_cnn.qbdc_infer(v, x, k, jc))

    def x(self, n, seed=1):
        return (np.random.default_rng(seed).standard_normal(
            (n, self.cfg.input_length)) * 0.3).astype(np.float32)

    def waves(self, n=10, seed=7):
        rng = np.random.default_rng(seed)
        length = self.cfg.input_length
        return {f"s{i:02d}": rng.standard_normal(int(rng.integers(
            length + 100, length + 1500))).astype(np.float32) * 0.3
            for i in range(n)}

    def nets(self):
        """Two JAX-initialized members, the second with moved BatchNorm
        statistics, and the port's copies."""
        jv = [self.init(jax.random.key(i)) for i in range(2)]
        rng = np.random.default_rng(0)
        jv[1] = {"params": jv[1]["params"], "batch_stats": jax.tree.map(
            lambda a: np.asarray(a) + rng.uniform(
                0.1, 0.5, np.shape(a)).astype(np.float32),
            jv[1]["batch_stats"])}
        return jv, [convert.cnn_variables_from_jax(v, self.cfg, "cpu")
                    for v in jv]

    def check_inference(self, nets, member):
        jv, pv = nets
        x = self.x(5)
        got = short_cnn.apply_infer(pv[member], torch.from_numpy(x),
                                    self.cfg).numpy()
        assert got.shape == (5, self.cfg.n_class)
        np.testing.assert_allclose(got, np.asarray(self.infer(jv[member], x)),
                                   **SCORE_TOL)
        np.testing.assert_allclose(
            short_cnn.apply_features(pv[member], torch.from_numpy(x),
                                     self.cfg).numpy(),
            np.asarray(self.features(jv[member], x)), **FEAT_TOL)

    def check_train(self, nets, seed):
        jv, pv = nets
        x = self.x(4, seed)
        out, stats = self.train(jv[1], x, jax.random.key(seed))
        got, new = short_cnn.apply_train(pv[1], torch.from_numpy(x),
                                         prng.key(seed, "cpu"), self.cfg)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                                   **self.train_tol)
        ref = convert.cnn_variables_from_jax(
            {"params": jv[1]["params"], "batch_stats": stats}, self.cfg,
            "cpu")
        assert set(new) == {k for k in ref if short_cnn.is_stat(k)}
        for k, t in new.items():
            np.testing.assert_allclose(t.detach().numpy(), ref[k].numpy(),
                                       **FEAT_TOL, err_msg=k)

    def check_qbdc(self, nets):
        jv, pv = nets
        x = self.x(6, 5)
        keys = jax.random.split(jax.random.key(9), 7)
        got = short_cnn.qbdc_infer(pv[0], torch.from_numpy(x),
                                   prng.split(prng.key(9, "cpu"), 7),
                                   self.cfg)
        assert got.shape == (7, 6, self.cfg.n_class)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(self.qbdc(jv[0], x, keys)),
                                   **SCORE_TOL)

    def check_committee(self, nets, pad_to=12):
        """``predict_songs_cnn`` (crops with the bucket padding) and
        ``qbdc_pool_probs`` of a two-member committee."""
        jv, pv = nets
        waves = self.waves()
        songs = list(waves)[:9]
        length = self.cfg.input_length
        jstore, store = JaxStore(waves, length), DeviceWaveformStore(
            waves, length, "cpu")
        jcom = JaxCommittee([], [JaxMember(f"c{i}", v, self.jcfg)
                                 for i, v in enumerate(jv)], self.jcfg)
        com = Committee([], [CNNMember(f"c{i}", v, self.cfg)
                             for i, v in enumerate(pv)], self.cfg,
                        device="cpu")
        key, pkey = jax.random.key(11), prng.key(11, "cpu")
        got = com.predict_songs_cnn(store, songs, pkey, pad_to=pad_to)
        assert got.shape == (2, pad_to, self.cfg.n_class)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jcom.predict_songs_cnn(
                jstore, songs, key, pad_to=pad_to)), **SCORE_TOL)
        np.testing.assert_allclose(
            com.qbdc_pool_probs(store, songs, pkey, k=5).numpy(),
            np.asarray(jcom.qbdc_pool_probs(jstore, songs, key, k=5)),
            **SCORE_TOL)

    def check_member_files(self, nets, tmp_path):
        """A JAX member file (``CETPU1`` msgpack) read by
        ``convert.cnn_member_from_jax`` and the port's own ``.npz`` member
        file both carry the trunk family and its frontend in their
        headers: loaded under a vgg config of the same depth and width,
        each comes back as this trunk with the same variables."""
        jv, pv = nets
        base = CNNConfig(n_channels=self.cfg.n_channels,
                         n_layers=self.cfg.n_layers,
                         input_length=self.cfg.input_length)
        path = str(tmp_path / "classifier_cnn.c1.msgpack")
        JaxMember("c1", jv[1], self.jcfg).save(path)
        member = convert.cnn_member_from_jax(path, base)
        assert member.name == "c1" and member.config == self.cfg
        ours = str(tmp_path / Committee.member_file(member))
        member.save(ours)
        back = CNNMember.load(ours, base, device="cpu")
        assert back.config == self.cfg
        for k, t in pv[1].items():
            assert torch.equal(member.variables[k], t), k
            assert torch.equal(back.variables[k], t), k

    def check_fit_many(self, nets):
        """Two members through ``fit_many``: the same epochs improve, the
        losses and the best variables (``bw_q`` too, for harm) agree."""
        jv, pv = nets
        waves = self.waves(9, 11)
        ids = list(waves)
        y = one_hot_np(np.random.default_rng(11).integers(0, 4, 9))
        tr, te = ids[:6], ids[6:]
        length = self.cfg.input_length
        jbest, jhist = jax_trainer.CNNTrainer(
            self.jcfg, JaxTrainConfig(**TC_KW)).fit_many(
                jv, JaxStore(waves, length), tr, y[:6], te, y[6:],
                jax.random.key(5), n_epochs=self.fit_epochs)
        best, hist = cnn_trainer.CNNTrainer(
            self.cfg, TrainConfig(**TC_KW)).fit_many(
                pv, DeviceWaveformStore(waves, length, "cpu"), tr, y[:6],
                te, y[6:], prng.key(5, "cpu"), n_epochs=self.fit_epochs)
        for h, r in zip(hist, jhist):
            assert [e["phase"] for e in h] == ["adam", "sgd_1"][
                :self.fit_epochs]
            assert [e["improved"] for e in h] == [e["improved"] for e in r]
            for e, er in zip(h, r):
                for k in ("train_loss", "val_loss", "val_f1"):
                    np.testing.assert_allclose(e[k], er[k], **LOSS_TOL,
                                               err_msg=k)
        # a member that improved returns trained weights
        assert any(e["improved"] for h in hist for e in h)
        for b, jb in zip(best, jbest):
            ref = convert.cnn_variables_from_jax(jb, self.cfg, "cpu")
            assert set(b) == set(ref)
            for k, t in b.items():
                np.testing.assert_allclose(t.numpy(), ref[k].numpy(),
                                           **WEIGHT_TOL, err_msg=k)
