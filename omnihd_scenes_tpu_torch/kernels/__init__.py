"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its
plain PyTorch version and a launch count."""


def launch_counts() -> dict:
    """The launch count of every kernel wrapper of the main paths (with
    rectify's setup kernels), the camera feed's batched JPEG decodes (host
    entropy decode + IDCT) and nvJPEG's (its yardstick, on no path), by
    name."""
    from omnihd_scenes_tpu_torch.data.jpeg import (decode_jpeg_planes,
                                                   nvjpeg_decode_planes)
    from omnihd_scenes_tpu_torch.kernels.jpeg_idct import jpeg_idct
    from omnihd_scenes_tpu_torch.kernels.lss_sample import lss_sample_bev
    from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
    from omnihd_scenes_tpu_torch.kernels import rectify as R

    return {'lss_sample_bev': lss_sample_bev.launches,
            'qconv3x3': qconv3x3.launches, 'rectify': R.rectify.launches,
            'rectify_pack_map': R.pack_map.launches,
            'rectify_footprint': R.footprint_table.launches,
            'rectify_taps': R.resize_taps.launches,
            'jpeg_idct': jpeg_idct.launches,
            'jpeg_decode': decode_jpeg_planes.calls,
            'nvjpeg_decode': nvjpeg_decode_planes.calls}
