"""The stage profiler's ``staged_call`` runs what ``Predictor`` runs: on
the CPU, at the mini configuration, its outputs equal the Predictor's bit
for bit, and it marks every stage once, in order."""

import numpy as np
import torch

from omnihd_scenes_tpu_torch.serve.predictor import Predictor
from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                     random_state_dict)
from omnihd_scenes_tpu_torch.tools.profile_components import staged_call
from tests.test_torch_port_weights import PORT_MINI_CFG

torch.set_num_threads(1)


def test_staged_call_equals_predictor():
    predictor = Predictor(PORT_MINI_CFG, random_state_dict(PORT_MINI_CFG, 5),
                          device='cpu', dtype=torch.float32)
    request = random_request(np.random.RandomState(5), PORT_MINI_CFG,
                             batch=2, n_points=600)
    marks = []
    got = staged_call(predictor, request, marks.append)
    want = predictor(*request)
    assert int(want[3].sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert marks[0] == 'inputs to the device'
    assert marks[-1] == 'decode: rotated IoU + NMS'
    assert len(marks) == len(set(marks)) == 13
