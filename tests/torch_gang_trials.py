"""Trial classes that the port's CPU gang tests (tests/test_torch_gang.py)
run in gang rank processes, which import them by ``module:qualname``.  No
JAX here: the ranks import torch and the port only.

- ``FromNpzMnistTrial``: MnistTrial starting from the weights in the
  ``.npz`` file that hparam ``init_npz`` names (converted JAX weights).
- ``KillOneRankMnistTrial``: the same, whose last rank SIGKILLs itself
  before step ``kill_at`` once (a marker file beside the weights records
  it), as a host losing a process would.
"""

import os
import signal

import numpy as np
import torch

from determined_tpu_torch.models import MnistTrial
from determined_tpu_torch.train import Callback
from determined_tpu_torch.utils import faults


class FromNpzMnistTrial(MnistTrial):
    def build_model(self):
        model = super().build_model()
        with np.load(self.context.hparams["init_npz"]) as f:
            model.load_state_dict({k: torch.tensor(f[k]) for k in f.files})
        return model


class KillOneRankMnistTrial(FromNpzMnistTrial):
    def build_callbacks(self):
        hp, dist = self.context.hparams, self.context.core.distributed
        marker = hp["init_npz"] + ".killed"

        class Kill(Callback):
            def on_training_start(self, trainer):
                if dist.rank != dist.size - 1 or os.path.exists(marker):
                    return

                class Hook:
                    def fire(self, site, **info):
                        if site == "train.step" and info.get("step") == hp["kill_at"]:
                            open(marker, "w").close()
                            os.kill(os.getpid(), signal.SIGKILL)

                faults.set_fault_injector(Hook())

        return {"kill": Kill()}
