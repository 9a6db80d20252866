"""Parameter remapping for staged pretraining (counterpart of
``omnihd_scenes_tpu/train/ckpt_remap.py``).

Parity target: the reference's partial-checkpoint loaders
(``tools/train.py:276-428``): ``load_lift_from`` (load a trained
camera/LSS branch, drop the detection head) and ``load_pts_from`` (load a
trained point-cloud branch), strict=False with per-key verification.
Configs chain them (``configs/bevfusion.py:5-18``) to assemble the fusion
model from single-modality pretrainings.

The JAX package merges flax ``params`` trees; here the target is a model's
parameters by name (``named_parameters``) and the source a checkpoint of
the port (``train/loop.py:save_checkpoint``) or any state_dict, of which
the parameters take part: BatchNorm's running statistics and step counters
stay at the target's values, as the JAX package leaves ``batch_stats``
alone.  Under the weight bridge's names the loaded set equals JAX's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

StateDict = Dict[str, torch.Tensor]
_BUFFERS = ('.running_mean', '.running_var', '.num_batches_tracked')
# The detection heads that load_lift_from drops: BEVFusion's ``head`` and
# BEVFusion-OCC's ``det_head`` (flax ``Anchor3DHead_0`` / ``det_head``).
LIFT_DROPS = ('head.', 'det_head.')


def parameters_of(state_dict: StateDict) -> StateDict:
    """The parameters of a state_dict: BatchNorm's buffers left out."""
    return {k: v for k, v in state_dict.items() if not k.endswith(_BUFFERS)}


def remap_params(target: StateDict, source: StateDict,
                 drop_prefixes: Tuple[str, ...] = (),
                 verbose: bool = True) -> Tuple[StateDict, Dict]:
    """Merge ``source`` into ``target``, leaving out the keys under
    ``drop_prefixes``.

    Returns (merged, report): the source keys loaded, skipped (not in the
    target), mismatched in shape, and the target keys missing (left at
    their values).
    """
    remapped = {k: v for k, v in source.items()
                if not any(k.startswith(p) for p in drop_prefixes)}
    merged = dict(target)
    loaded, skipped, mismatched = [], [], []
    for key, value in remapped.items():
        if key not in target:
            skipped.append(key)
        elif tuple(target[key].shape) != tuple(value.shape):
            mismatched.append(key)
        else:
            merged[key] = value.detach().to(target[key].dtype).clone()
            loaded.append(key)
    missing = [k for k in target if k not in remapped]
    report = {'loaded': loaded, 'skipped': skipped,
              'mismatched': mismatched, 'missing': missing}
    if verbose:
        print(f'[ckpt_remap] loaded {len(loaded)} keys, skipped '
              f'{len(skipped)} (not in model), {len(mismatched)} shape '
              f'mismatches, {len(missing)} left at init')
        for k in mismatched:
            print(f'[ckpt_remap]   shape mismatch: {k}')
    return merged, report


def load_lift_from(target: StateDict, source: StateDict,
                   verbose: bool = True) -> Tuple[StateDict, Dict]:
    """Load a trained camera/LSS branch's parameters, dropping its
    detection head (reference ``load_lift_from``, tools/train.py:377-405)."""
    return remap_params(target, parameters_of(source),
                        drop_prefixes=LIFT_DROPS, verbose=verbose)


def load_pts_from(target: StateDict, source: StateDict,
                  verbose: bool = True) -> Tuple[StateDict, Dict]:
    """Load a trained point-cloud branch's parameters (reference
    ``load_pts_from``)."""
    return remap_params(target, parameters_of(source), verbose=verbose)
