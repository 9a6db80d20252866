"""Data-parallel training over ranks (counterpart of
``omnihd_scenes_tpu/parallel``): ``distributed`` joins the process group
and collects results, ``mesh`` holds the group and its collectives."""
