"""The LSS view transform's backward kernels' share of their roofline, in
%: the bound of the benchmark's frozen ``lss_sample_bev_backward_cost``
on the cell's geometry (f32 operations over the f32 peak, bytes over
3.35 TB/s, the larger) over the device time of the kernels named
``lss_backward`` (count, fill, gather; the ``torch.cumsum`` between
them is a library scan and is not counted), profiler."""

import torch

from perfbench import roofline, traffic
from perfbench.reference import bevfusion as ref

KERNEL = 'lss_backward'


def launch_cost(model: dict, batch: int, dtype, device):
    """(operations, bytes) of one backward over a batch of the ring rig."""
    lss = model['lss']
    f_h, f_w = ref.feat_hw(lss)
    n = model['num_views']
    nx, ny, nz = ref.bev_nx(lss)
    rots, trans = (torch.from_numpy(a).to(device)
                   for a in traffic.ring_rig_img2lidar(lss['final_dim']))
    rots = rots.expand(batch, *rots.shape)
    trans = trans.expand(batch, *trans.shape)
    minv = torch.linalg.inv_ex(rots.float())[0]
    mt = -torch.einsum('...ij,...j->...i', minv, trans.float())
    feat = torch.empty(batch, n, f_h, f_w, lss['camC'], dtype=dtype,
                       device=device)
    depth = torch.empty(batch, n, f_h, f_w, ref.depth_bins(lss),
                        dtype=dtype, device=device)
    grad = torch.empty(batch, ny, nx, nz, lss['camC'], dtype=dtype,
                       device=device)
    geom = ref._Geom(lss['final_dim'], (f_h, f_w), lss['camera_depth_range'],
                     lss['pc_range'][:3], (lss['grid'],) * 3, (nx, ny, nz))
    solve_x = (tuple(lss['cam_solve_x']) + (True,) * n)[:n]
    return roofline.lss_sample_bev_backward_cost(grad, feat, depth, minv, mt,
                                                 geom, solve_x)


def read(run):
    seconds, launches = run.timeline.device_s(lambda name: KERNEL in name)
    if not launches:
        return None
    drv = run.driver
    dtype = torch.bfloat16 if drv.train['policy'] == 'bf16' else torch.float32
    ops, nbytes = launch_cost(drv.model_cfg, drv.mix['batch'], dtype,
                              run.device)
    ms, _ = roofline.bound(ops, 'f32', nbytes)
    steps = run.window.requests
    return 100.0 * steps * ms * 1e-3 / seconds
