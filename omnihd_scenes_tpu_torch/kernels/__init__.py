"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its
plain PyTorch version and a launch count."""


def launch_counts() -> dict:
    """The launch count of every kernel wrapper of the main paths, and of
    nvJPEG's batched decode (a library call), by name."""
    from omnihd_scenes_tpu_torch.data.jpeg import decode_jpeg_planes
    from omnihd_scenes_tpu_torch.kernels.lss_sample import lss_sample_bev
    from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
    from omnihd_scenes_tpu_torch.kernels.rectify import rectify

    return {'lss_sample_bev': lss_sample_bev.launches,
            'qconv3x3': qconv3x3.launches, 'rectify': rectify.launches,
            'nvjpeg_decode': decode_jpeg_planes.calls}
