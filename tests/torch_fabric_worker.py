"""A fabric worker over the port's synthetic workload, on the CPU
(counterpart of ``tests/fabric_worker.py``).

    python tests/torch_fabric_worker.py FABRIC_DIR HOST_ID WS_ROOT MODE \
        EPOCHS N_USERS LEASE_S TARGET_LIVE [SIZES]

Runs one ``FleetServer`` (``device="cpu"``) fed from the coordinator's
assignment file (``serve.hosts.run_worker``); ``SIZES`` (``sizes_arg``,
comma-separated) gives the users their pool sizes, as the JAX worker's
ninth argument does.  It appends each finished
user's result to ``FABRIC_DIR/results_<HOST_ID>.jsonl`` (append and
fsync; the tests read these).  ``CETPU_FAULTS`` reaches the worker through
its environment.  The production worker is ``amg_test --fabric-worker``.
"""

import json
import os
import sys
import time


def main(argv) -> int:
    (fabric_dir, host_id, ws_root, mode, epochs, n_users, lease_s,
     target) = argv[:8]
    sizes = [int(n) for n in argv[8].split(",")] if len(argv) > 8 else None
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from consensus_entropy_tpu_torch.fleet import FleetScheduler
    from consensus_entropy_tpu_torch.obs.trace import Tracer
    from consensus_entropy_tpu_torch.resilience.preemption import (
        EXIT_PREEMPTED,
        Preempted,
        PreemptionGuard,
    )
    from consensus_entropy_tpu_torch.serve import ServeConfig
    from consensus_entropy_tpu_torch.serve.hosts import (
        fabric_paths,
        run_worker,
    )
    from tests.torch_fabric_workload import (
        build_entry_factory,
        make_cfg,
        user_specs,
    )

    cfg = make_cfg(mode=mode, epochs=int(epochs))
    specs = user_specs(int(n_users), sizes=sizes)
    results_path = os.path.join(fabric_dir, f"results_{host_id}.jsonl")

    def on_result(rec):
        line = {"user": str(rec["user"]), "error": rec["error"],
                "host": host_id, "t": round(time.time(), 3)}
        if rec["result"] is not None:
            line["result"] = {
                "trajectory": rec["result"]["trajectory"],
                "final_mean_f1": rec["result"]["final_mean_f1"]}
        with open(results_path, "ab") as f:
            f.write((json.dumps(line) + "\n").encode("utf-8"))
            f.flush()
            os.fsync(f.fileno())

    # the span WAL where the CLI worker puts it, the run id shared with
    # the coordinator so a moved user's trace continues
    tracer = Tracer(fabric_paths(fabric_dir, host_id)["spans"],
                    run_id=f"{cfg.mode}-{cfg.seed}", host=host_id)
    scheduler = FleetScheduler(cfg, scoring_by_width=True, device="cpu",
                               tracer=tracer)
    try:
        with PreemptionGuard() as guard:
            run_worker(fabric_dir, host_id,
                       build_entry=build_entry_factory(ws_root, cfg, specs),
                       scheduler=scheduler,
                       config=ServeConfig(target_live=int(target),
                                          planner_epoch=2),
                       on_result=on_result, lease_s=float(lease_s),
                       preemption=guard)
    except Preempted:
        return EXIT_PREEMPTED
    finally:
        tracer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
