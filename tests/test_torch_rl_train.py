"""The reference's training acceptance for the learned submission policy
(``tests/test_rl.py::test_train_acceptance_vs_hand_designed``), run on
the port's own training on the CPU.

The smoke recipe trains five iterations; on a held-out grid seed the
trained head's mean perceived inter-stage wait is no worse than
Per-Stage's and within 15% of ASA's, its held-out reward improves on the
init head's, and only the no-dependency policies pay OH core-hours. It
stands or fails on the port's run: near-ties of the sampled actions let
the two packages' training curves part, so it is not an equality with
the reference's run (``tests/test_torch_rl.py`` holds each piece to the
reference). A file of its own, so that ``--dist loadfile`` gives it a
worker.
"""

import torch

from repro_torch.core import prng
from repro_torch.rl import policy as P
from repro_torch.rl import train as T
from repro_torch.xsim.grid import XSimConfig

torch.set_num_threads(1)

TINY_SIM = XSimConfig(n_warm=16, n_backlog=12, n_arrivals=16, max_stages=9,
                      t0=1800.0)


def test_train_acceptance_vs_hand_designed():
    cfg = T.TrainConfig(iters=5, n_seeds=8, lr=0.5, sim=TINY_SIM)
    res = T.train(cfg, device="cpu")
    assert len(res.rewards) == 5 and len(res.entropies) == 5
    assert len(res.telemetry) == 5
    assert res.telemetry[0]["n_scenarios"] == 144
    assert all(torch.equal(a, b) for a, b in zip(
        res.init_params, P.init_params(prng.PRNGKey(cfg.seed),
                                       device="cpu")))
    fleet = T.warmed_fleet(cfg, grid_seed=1234, device="cpu")
    ev = T.evaluate(res.params, cfg, eval_seed=1234, fleet=fleet,
                    device="cpu")
    ev0 = T.evaluate(res.init_params, cfg, eval_seed=1234, fleet=fleet,
                     device="cpu")
    assert set(ev) == {"bigjob", "per_stage", "asa", "asa_naive", "rl"}
    assert ev["rl"]["reward"] > ev0["rl"]["reward"]
    assert ev["rl"]["twt_s"] <= ev["per_stage"]["twt_s"]
    assert ev["rl"]["twt_s"] <= 1.15 * ev["asa"]["twt_s"]
    # the OH ledger is consistent: only the no-dependency policies pay it
    assert ev["asa"]["oh_hours"] == 0.0
    assert ev["per_stage"]["oh_hours"] == 0.0
