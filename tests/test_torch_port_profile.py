"""The train step's stage marks (``make_train_step(..., mark)``, which
the benchmark's training cell passes) change nothing it computes.
The stage profiler runs ``Predictor`` itself with the program's spans on
(``tests/test_torch_port_trace.py``)."""

import numpy as np
import torch

from omnihd_scenes_tpu_torch.serve.synthetic import random_state_dict
from tests.test_torch_port_weights import PORT_MINI_CFG

torch.set_num_threads(1)


def test_staged_train_step_equals_the_train_step():
    """The train step with the profiler's stage marks runs what it runs
    without them: the same loss and the same parameters and statistics
    after the step, bit for bit, with each stage marked once, in order (a
    ResNet18 variant of the mini configuration, sorted pillars, bf16
    policy, on the CPU)."""
    import dataclasses

    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.serve.synthetic import random_train_batch
    from omnihd_scenes_tpu_torch.train.amp import bf16_policy
    from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
    from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                    make_train_step)
    from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                     make_optimizer)

    cfg = dataclasses.replace(
        PORT_MINI_CFG, resnet_depth=18,
        pillars=dataclasses.replace(PORT_MINI_CFG.pillars,
                                    pillar_impl='sorted'))
    sd = random_state_dict(cfg, 6)
    batch = random_train_batch(np.random.RandomState(6), cfg, 2,
                               n_points=400, max_gt=6)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    depth_range = cfg.lss.camera_depth_range
    ends, losses, marks = [], [], []
    for mark in (None, marks.append):
        model = BEVFusion(cfg)
        model.load_state_dict(sd)
        state = create_train_state(model, lambda p: make_optimizer(
            p, make_lr_schedule(1e-3, 10)))
        fn = make_loss_fn_generic(model, 'bevfusion', cfg.pillars.anchors(),
                                  camera_depth_range=depth_range)
        _, loss, _ = make_train_step(bf16_policy(fn), mark)(state, batch)
        assert state.step == 1
        losses.append(loss)
        ends.append(model.state_dict())
    assert marks == ['loss', 'backward', 'optimizer']
    assert torch.equal(losses[0], losses[1])
    for k, v in ends[0].items():
        assert torch.equal(ends[1][k], v), k
