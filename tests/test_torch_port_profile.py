"""The stage profiler's ``staged_call`` runs what ``Predictor`` runs: on
the CPU, at the mini configuration, in float and in the int8 tier, its
outputs equal the Predictor's bit for bit, and it marks every stage
once, in order."""

import numpy as np
import pytest
import torch

from omnihd_scenes_tpu_torch.serve.predictor import Predictor, calibrate
from omnihd_scenes_tpu_torch.serve.synthetic import (random_request,
                                                     random_state_dict)
from omnihd_scenes_tpu_torch.tools.profile_components import staged_call
from tests.test_torch_port_weights import PORT_MINI_CFG

torch.set_num_threads(1)


@pytest.mark.parametrize('int8', [False, True])
def test_staged_call_equals_predictor(int8):
    state_dict = random_state_dict(PORT_MINI_CFG, 5)
    request = random_request(np.random.RandomState(5), PORT_MINI_CFG,
                             batch=2, n_points=600)
    quant = (calibrate(PORT_MINI_CFG, state_dict, [request], device='cpu',
                       dtype=torch.float32) if int8 else None)
    predictor = Predictor(PORT_MINI_CFG, state_dict, device='cpu',
                          dtype=torch.float32, quant_state=quant)
    marks = []
    got = staged_call(predictor, request, marks.append)
    want = predictor(*request)
    assert int(want[3].sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert marks[0] == 'inputs to the device'
    assert marks[-1] == 'decode: rotated IoU + NMS'
    assert len(marks) == len(set(marks)) == 12
    assert 'LSS: view transform (lss_sample_bev)' in marks
