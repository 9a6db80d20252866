"""The LSS sampling kernel's share of its roofline, in %: its bound, the
bytes it must move (the benchmark's frozen ``lss_sample_bev_bytes`` on
the cell's geometry) over 3.35 TB/s (its 2 C operations a gathered row
bound it far less), over the device time of its launches
(``lss_sample_kernel``, profiler)."""

import torch

from perfbench import roofline, traffic
from perfbench.reference import bevfusion as ref

KERNEL = 'lss_sample_kernel'


def launch_bytes(model: dict, batch: int, dtype, device) -> int:
    """Bytes one launch over a batch of the ring rig must move."""
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
    geom = ref._Geom(lss['final_dim'], (f_h, f_w), lss['camera_depth_range'],
                     lss['pc_range'][:3], (lss['grid'],) * 3, (nx, ny, nz))
    solve_x = (tuple(lss['cam_solve_x']) + (True,) * n)[:n]
    return roofline.lss_sample_bev_bytes(feat, depth, minv, mt, geom,
                                         solve_x, dtype)


def read(run):
    seconds, launches = run.timeline.device_s(lambda name: KERNEL in name)
    if not launches:
        return None
    drv = run.driver
    nbytes = launch_bytes(drv.model_cfg, drv.mix['batch'], drv.dtype,
                          run.device)
    ms, _ = roofline.bound(0, 'bf16', nbytes)
    return 100.0 * launches * ms * 1e-3 / seconds
