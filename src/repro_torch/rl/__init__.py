"""repro_torch.rl: the learned submission-policy head, trained on fleet
simulator rollouts (port of ``repro.rl``).

A small MLP maps an observation of the scenario (queue state and the live
Algorithm-1 posterior) to a distribution over the §4.3 wait bins and acts
as the submit-lead-time inside the fleet simulator (policy id 4). The
batched sweep is the experience generator, through the ``freed_scan``
kernel on CUDA; training is REINFORCE with a batch baseline over
resampled scenario grids, its gradient by torch autograd through the
policy head alone.
"""

from repro_torch.rl.features import FEATURE_NAMES, N_FEATURES, observe
from repro_torch.rl.policy import (PolicyParams, act_greedy, act_sample,
                                   init_params, log_prob, logits)
from repro_torch.rl.rollout import Trajectory, collect, episode_rewards
from repro_torch.rl.train import TrainConfig, TrainResult

# train()/evaluate() live in repro_torch.rl.train and are not re-exported:
# a package attribute named `train` would shadow the submodule.

__all__ = [
    "FEATURE_NAMES", "N_FEATURES", "observe",
    "PolicyParams", "act_greedy", "act_sample", "init_params", "log_prob",
    "logits",
    "Trajectory", "collect", "episode_rewards",
    "TrainConfig", "TrainResult",
]
