"""The quick-tier learned-accuracy bound of ``tests/test_learning_quick.py``
on the port: a micro PointPillars trained on the synthetic train split (8
samples) on the CPU through the port's whole stack (dataset -> loader ->
voxelize -> PFN -> SECOND -> anchor assignment and losses -> clip + AdamW
-> decode -> NMS -> result JSON -> the devkit eval) must reach the same
mAP > 0.5 and NOS > 0.45, with the same recipe: 350 epochs, lr 1e-2 with
20 warm-up steps, the cropped +-40 x +-30 m range, 1 m pillars, channels
16/32/32.  Weights come from ``init_weights`` (flax's initialisers, drawn
from a seeded ``torch.Generator``), so the run is deterministic but not
the JAX run's.  ``chip_smoke.py`` runs the same recipe on the card.
"""

import time

import numpy as np
import torch

from chip_smoke import micro_train

torch.set_num_threads(1)


def test_micro_train_reaches_map_bound(synthetic_dataroot, tmp_path):
    t0 = time.perf_counter()
    metrics, losses = micro_train(synthetic_dataroot, str(tmp_path),
                                  device='cpu')
    print(f'micro-train on the CPU: {time.perf_counter() - t0:.1f} s, '
          f'{metrics}')
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert metrics['mAP'] > 0.5, metrics
    assert metrics['NOS'] > 0.45, metrics
