"""The port's acquisition registry against ``consensus_entropy_tpu.acquire``:
registration order, the strategies' flags, re-registration and the
``probs_plan`` routing."""

import pytest
import torch

from consensus_entropy_tpu import acquire as jax_acquire
from consensus_entropy_tpu_torch import acquire
from consensus_entropy_tpu_torch.acquire.base import AcquisitionStrategy
from consensus_entropy_tpu_torch.config import ALConfig

torch.set_num_threads(1)

FLAGS = ("needs_probs", "probs_source", "uses_weights", "uses_hc_table",
         "uses_hc_entropy")


def test_registry_order_matches_jax():
    assert acquire.available_modes() == (
        "mc", "hc", "mix", "rand", "qbdc", "wmc")
    assert acquire.available_modes() == jax_acquire.available_modes()
    with pytest.raises(ValueError, match="unknown mode"):
        acquire.get("zzz")


@pytest.mark.parametrize("mode", ["mc", "hc", "mix", "rand", "qbdc", "wmc"])
def test_strategy_flags_match_jax(mode):
    port, ref = acquire.get(mode), jax_acquire.get(mode)
    assert port.name == ref.name == mode
    assert type(port).__name__ == type(ref).__name__
    for flag in FLAGS:
        assert getattr(port, flag) == getattr(ref, flag), flag


def test_conflicting_reregistration_fails_loud():
    class Imposter(AcquisitionStrategy):
        name = "mc"

    with pytest.raises(ValueError, match="already registered"):
        acquire.register(Imposter())
    acquire.register(acquire.MachineConsensus())      # same type: a no-op
    assert type(acquire.get("mc")) is acquire.MachineConsensus

    class Nameless(AcquisitionStrategy):
        pass

    with pytest.raises(ValueError, match="no name"):
        acquire.register(Nameless())


def test_probs_plan_routes_by_probs_source():
    # each mode's producer is routed by probs_source: qbdc's dropout
    # committee, the stored committee else; probs_plan (the fleet's
    # stacked producer) follows the same routing, None without probs
    routes = {m: (acquire.get(m).needs_probs, acquire.get(m).probs_source)
              for m in acquire.available_modes()}
    assert routes == {"mc": (True, "committee"), "hc": (False, "committee"),
                      "mix": (True, "committee"),
                      "rand": (False, "committee"), "qbdc": (True, "qbdc"),
                      "wmc": (True, "committee")}

    class Recorder:
        def cnn_score_plan(self, store, song_ids, key, *, pad_to):
            return ("cnn", pad_to)

        def qbdc_score_plan(self, store, song_ids, key, *, k, pad_to):
            return ("qbdc", k, pad_to)

    plans = {m: acquire.get(m).probs_plan(Recorder(), None, [1], None,
                                          pad_to=8, config=ALConfig())
             for m in acquire.available_modes()}
    assert plans == {"mc": ("cnn", 8), "hc": None, "mix": ("cnn", 8),
                     "rand": None, "qbdc": ("qbdc", ALConfig().qbdc_k, 8),
                     "wmc": ("cnn", 8)}


def test_config_checks_match_jax():
    from consensus_entropy_tpu.config import ALConfig as JaxALConfig
    from consensus_entropy_tpu.config import ScoringConfig as JaxScoring
    from consensus_entropy_tpu_torch.config import NUM_CLASSES, ScoringConfig

    assert NUM_CLASSES == 4
    for field in ("queries", "qbdc_k", "consensus_weight_alpha"):
        assert getattr(ALConfig(), field) == getattr(JaxALConfig(), field)
    for field in ("pad_pool_to", "tie_break"):
        assert getattr(ScoringConfig(), field) == getattr(JaxScoring(), field)
    for bad in ({"qbdc_k": 0}, {"consensus_weight_alpha": 1.5}):
        with pytest.raises(ValueError):
            ALConfig(**bad)
        with pytest.raises(ValueError):
            JaxALConfig(**bad)
