"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its
plain PyTorch version and a launch count."""


def launch_counts() -> dict:
    """The launch count of every kernel wrapper of the main paths (the
    LSS view transform's forward, its backward and its fields-in entry,
    rectify's setup kernels and the training augmentations), the camera
    feed's batched JPEG decodes (host entropy decode + IDCT), nvJPEG's
    (its yardstick, on no path), and the calls of the plain PyTorch
    deformable attention and scatter splat, by name."""
    from omnihd_scenes_tpu_torch.data.jpeg import (decode_jpeg_planes,
                                                   nvjpeg_decode_planes)
    from omnihd_scenes_tpu_torch.kernels.crop_resize_flip import (
        crop_resize_flip)
    from omnihd_scenes_tpu_torch.kernels.jpeg_idct import jpeg_idct
    from omnihd_scenes_tpu_torch.kernels.lss_sample import (
        lss_sample, lss_sample_bev, lss_sample_bev_backward)
    from omnihd_scenes_tpu_torch.kernels.photometric import photometric
    from omnihd_scenes_tpu_torch.kernels.qconv import qconv3x3
    from omnihd_scenes_tpu_torch.kernels import rectify as R
    from omnihd_scenes_tpu_torch.ops.bev_pool import lss_splat
    from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (
        multi_scale_deformable_attn)

    return {'lss_sample_bev': lss_sample_bev.launches,
            'lss_sample_bev_backward': lss_sample_bev_backward.launches,
            'lss_sample': lss_sample.launches,
            'qconv3x3': qconv3x3.launches, 'rectify': R.rectify.launches,
            'rectify_pack_map': R.pack_map.launches,
            # Both geometry tables come from one launch: one count.
            'rectify_footprint': R.geometry_tables.launches,
            'rectify_taps': R.geometry_tables.launches,
            'jpeg_idct': jpeg_idct.launches,
            'photometric': photometric.launches,
            'crop_resize_flip': crop_resize_flip.launches,
            'jpeg_decode': decode_jpeg_planes.calls,
            'nvjpeg_decode': nvjpeg_decode_planes.calls,
            'msda': multi_scale_deformable_attn.calls,
            'lss_splat': lss_splat.calls}
