"""GT-as-prediction fake result generator (eval self-check).

Parity target: ``newscenes_devkit/create_fake_result.py`` — dumps the
val-split ground truth as a prediction JSON with confidence 1.0; feeding
it to the detection eval must yield mAP ~= 1 and TP errors ~= 0.  This
is the de-facto end-to-end integration test of the whole eval stack
(BASELINE config #1).
"""

from __future__ import annotations

import json

from omnihd_scenes_tpu_torch.devkit.database import NewScenes


def create_fake_result(newsc: NewScenes, split: str = 'val_mini') -> dict:
    """Build the submission dict {'meta':..., 'results': {token: [...]}}."""
    sample_tokens = [
        s['token'] for s in newsc.sample
        if newsc.get('sample', s['token'])['scene_token'] in newsc.scene_split[split]
    ]

    from omnihd_scenes_tpu_torch.eval.detection.utils import category_to_detection_name

    results = {}
    for token in sample_tokens:
        annos = []
        for box in newsc.get_annotation_box(token):
            # Camera-invisible boxes are filtered from GT during eval;
            # emitting them as predictions would create guaranteed FPs.
            if box.visibility != 1:
                continue
            # The reference passes raw names straight through; we map to the
            # eval label space (identity for already-mapped names) so the
            # self-check also works on raw-category databases.
            name = category_to_detection_name(box.name) or box.name
            annos.append(dict(
                sample_token=token,
                translation=box.center.tolist(),
                size=box.wlh.tolist(),
                rotation=box.orientation.elements.tolist(),
                velocity=box.velocity[:2].tolist(),
                detection_name=name,
                detection_score=1,
            ))
        results[token] = annos

    return {'meta': dict(use_lidar=False, use_camera=True, use_radar=True),
            'results': results}


def write_fake_result(newsc: NewScenes, out_path: str,
                      split: str = 'val_mini') -> str:
    submission = create_fake_result(newsc, split)
    with open(out_path, 'w') as f:
        json.dump(submission, f)
    return out_path


if __name__ == '__main__':
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument('--dataroot', default='data/newscenes-mini')
    p.add_argument('--version', default='v1.0-mini')
    p.add_argument('--split', default='val_mini')
    p.add_argument('--out', default='result_newsc_fakegt.json')
    args = p.parse_args()

    db = NewScenes(version=args.version, dataroot=args.dataroot, verbose=True)
    print('Results written to', write_fake_result(db, args.out, args.split))
