"""Tracking metrics: per-threshold MOT accumulation + the full
nuScenes-style metric set (counterpart of
``omnihd_scenes_tpu/eval/tracking/algo.py``, NumPy in f64 as there).

Parity target: ``newscenes_devkit/eval/tracking/{algo,metrics,mot}.py``
(the nuScenes tracking suite, which ships broken in the reference —
SURVEY.md §2.2) — self-contained, no ``motmetrics``:

* per scene and frame, predictions above a recall-derived score
  threshold are matched to GT by center distance (< dist_th_tp) with
  identity-preserving priority (a GT prefers its previously matched
  track id — the standard MOT matching rule);
* per-threshold rows carry tp/fp/fn/ids plus the track-quality metrics
  mt/ml (mostly tracked ≥80% / mostly lost ≤20% of a GT track's life,
  py-motmetrics definitions), frag (tracked→lost transitions inside the
  tracked span, ``metrics.py num_fragmentations_custom``), tid (first
  GT appearance → first TP, seconds, averaged over ever-tracked tracks,
  ``metrics.py track_initialization_duration``), lgd (longest untracked
  gap over the GT span, seconds, ``metrics.py longest_gap_duration``),
  faf (false alarms per frame × 100, ``metrics.py faf``);
* AMOTA/AMOTP average MOTAR/MOTP over ``nelem`` recall thresholds
  (``AVG_METRIC_MAP``), and the legacy metrics are reported at the
  best-MOTA threshold (reference ``evaluate.py:143-156``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

SAMPLE_PERIOD_S = 0.5      # approx. keyframe period (reference metrics.py)

# Per-threshold row fields (reference constants.py TRACKING_METRICS sans
# the two averages computed on top).
MD_FIELDS = ['confidence', 'recall', 'motar', 'mota', 'motp', 'faf',
             'gt', 'tp', 'fp', 'fn', 'ids', 'frag', 'mt', 'ml',
             'tid', 'lgd']


def _match_frame(gts: List, preds: List, dist_th: float,
                 prev_match: Dict[str, str]):
    """Greedy distance matching with identity preference.

    gts/preds: lists of TrackingBox for one frame, one class.
    prev_match: gt track id -> pred track id from the previous frame.
    Returns (matches [(gt, pred, dist)], unmatched_gts, unmatched_preds).
    """
    if not gts or not preds:
        return [], list(gts), list(preds)

    gt_xy = np.array([g.translation[:2] for g in gts])
    pr_xy = np.array([p.translation[:2] for p in preds])
    dist = np.linalg.norm(gt_xy[:, None] - pr_xy[None, :], axis=-1)

    cand = dist < dist_th
    # Identity preference: zero-cost bonus for continuing a track.
    bonus = np.zeros_like(dist)
    for i, g in enumerate(gts):
        want = prev_match.get(g.tracking_id)
        if want is not None:
            for j, p in enumerate(preds):
                if p.tracking_id == want:
                    bonus[i, j] = -1e3
    cost = np.where(cand, dist + bonus, np.inf)

    matches = []
    used_g, used_p = set(), set()
    order = np.dstack(np.unravel_index(np.argsort(cost, axis=None),
                                       cost.shape))[0]
    for gi, pj in order:
        if cost[gi, pj] == np.inf:
            break
        if gi in used_g or pj in used_p:
            continue
        used_g.add(gi)
        used_p.add(pj)
        matches.append((gts[gi], preds[pj], dist[gi, pj]))
    un_g = [g for i, g in enumerate(gts) if i not in used_g]
    un_p = [p for j, p in enumerate(preds) if j not in used_p]
    return matches, un_g, un_p


def _track_metrics(timelines: Dict, period: float = SAMPLE_PERIOD_S):
    """MT/ML/FRAG/TID/LGD from per-GT-track (frame, matched, time)
    timelines.

    Each timeline is the ordered list of ``(frame_idx, matched,
    t_seconds)`` for the frames where the GT track is present;
    ``t_seconds`` is the real sample timestamp when the caller supplied
    one (``None`` falls back to ``frame_idx * period``).  Definitions
    follow the reference ``metrics.py`` / py-motmetrics:
      mt/ml  — tracks matched on >=80% / <=20% of their frames;
      frag   — matched->unmatched transitions within the matched span;
      tid    — time from first GT appearance to first TP (seconds),
               averaged over ever-matched tracks (nan when none);
      lgd    — longest consecutive untracked time span over the GT
               track's life (initial gap included), same averaging.
               Each unmatched frame contributes its dwell time (the gap
               to the next frame; the last frame reuses the previous
               dwell) so non-uniform sample cadences are measured in
               real seconds, not frame counts.
    """
    mt = ml = frag = 0
    tid_sum = lgd_sum = 0.0
    matched_tracks = 0
    for frames in timelines.values():
        idx = [f for f, _, _ in frames]
        hit = [m for _, m, _ in frames]
        ts = [(idx[i] * period if frames[i][2] is None else frames[i][2])
              for i in range(len(frames))]
        n = len(frames)
        n_hit = sum(hit)
        ratio = n_hit / n if n else 0.0
        if ratio >= 0.8:
            mt += 1
        elif ratio <= 0.2:
            ml += 1
        if n_hit == 0:
            continue
        matched_tracks += 1
        first_hit = hit.index(True)
        last_hit = n - 1 - hit[::-1].index(True)
        # frag: interruptions inside the tracked span.
        frag += sum(1 for i in range(first_hit + 1, last_hit + 1)
                    if not hit[i] and hit[i - 1])
        # tid: real elapsed time from first GT appearance to first TP.
        tid_sum += ts[first_hit] - ts[0]
        # lgd: longest consecutive unmatched time span (leading gap
        # counts, reference longest_gap_duration iterates the full GT
        # span).  dwell[i] = time covered by frame i.
        dwell = [ts[i + 1] - ts[i] for i in range(n - 1)]
        dwell.append(dwell[-1] if dwell else period)
        gap = cur = 0.0
        for i in range(n):
            if hit[i]:
                gap = max(gap, cur)
                cur = 0.0
            else:
                cur += dwell[i]
        lgd_sum += max(gap, cur)
    if matched_tracks == 0:
        tid = lgd = float('nan')
    else:
        tid = tid_sum / matched_tracks
        lgd = lgd_sum / matched_tracks
    return {'mt': mt, 'ml': ml, 'frag': frag, 'tid': tid, 'lgd': lgd}


def accumulate_class(gt_scenes: Sequence[List[List]],
                     pred_scenes: Sequence[List[List]],
                     dist_th: float, score_thr: float,
                     collect_match_scores: bool = False,
                     scene_times: Sequence[List[float]] = None) -> Dict:
    """MOT counts for one class over scene-grouped ordered frames at one
    score threshold.

    gt_scenes/pred_scenes: per scene, the ordered list of per-frame
    TrackingBox lists.  Identity bookkeeping and track timelines are
    per scene (no cross-scene state).  scene_times: optional per-scene
    lists of frame timestamps in SECONDS; when given, TID/LGD are
    measured in real elapsed time instead of frame_idx ×
    ``SAMPLE_PERIOD_S``.
    """
    tp = fp = fn = ids = 0
    n_frames = 0
    dist_sum = 0.0
    match_scores: List[float] = []
    timelines: Dict[Tuple[int, str], List[Tuple[int, bool, float]]] = {}
    for si, (gt_frames, pred_frames) in enumerate(zip(gt_scenes,
                                                      pred_scenes)):
        times = scene_times[si] if scene_times is not None else None
        prev_match: Dict[str, str] = {}
        for fi, (gts, preds) in enumerate(zip(gt_frames, pred_frames)):
            t = times[fi] if times is not None else None
            n_frames += 1
            preds = [p for p in preds if p.tracking_score >= score_thr]
            matches, un_g, un_p = _match_frame(gts, preds, dist_th,
                                               prev_match)
            tp += len(matches)
            fp += len(un_p)
            fn += len(un_g)
            dist_sum += sum(m[2] for m in matches)
            if collect_match_scores:
                match_scores.extend(p.tracking_score
                                    for _, p, _ in matches)
            matched_ids = {g.tracking_id for g, _, _ in matches}
            for g in gts:
                timelines.setdefault((si, g.tracking_id), []).append(
                    (fi, g.tracking_id in matched_ids, t))
            new_match = {}
            for g, p, _ in matches:
                if g.tracking_id in prev_match \
                        and prev_match[g.tracking_id] != p.tracking_id:
                    ids += 1
                new_match[g.tracking_id] = p.tracking_id
            prev_match = new_match
    ngt = tp + fn
    out = {'tp': tp, 'fp': fp, 'fn': fn, 'ids': ids, 'gt': ngt,
           'n_frames': n_frames,
           'motp': dist_sum / tp if tp > 0 else float('nan'),
           'recall': tp / ngt if ngt > 0 else 0.0,
           'faf': fp / n_frames * 100 if n_frames else 0.0}
    out.update(_track_metrics(timelines))
    if collect_match_scores:
        out['match_scores'] = match_scores
    return out


def compute_thresholds(gt_scenes, pred_scenes, dist_th: float,
                       nelem: int, min_recall: float):
    """Recall-derived score thresholds (reference algo.py
    compute_thresholds:300-343): one permissive accumulation collects
    matched prediction scores; thresholds are np.interp of the
    (recall, score) curve at the target recalls (right=0 below the
    curve, nan above the achieved maximum)."""
    base = accumulate_class(gt_scenes, pred_scenes, dist_th,
                            -np.inf, collect_match_scores=True)
    return _thresholds_from_base(base, nelem, min_recall)


def _thresholds_from_base(base: Dict, nelem: int, min_recall: float):
    ngt = max(base['gt'], 1)
    scores = np.sort(np.asarray(base['match_scores'], np.float64))[::-1]
    recalls = np.linspace(min_recall, 1.0, nelem).round(12)
    if scores.size == 0:
        return np.full(nelem, np.nan), recalls
    rec = np.arange(1, len(scores) + 1) / ngt
    # np.interp needs ascending xp: rec ascends, scores descend with it.
    thresholds = np.interp(recalls, rec, scores, right=0.0)
    thresholds[recalls > rec.max()] = np.nan
    return thresholds, recalls


def accumulate_curve(gt_scenes, pred_scenes, dist_th: float,
                     nelem: int = 40, min_recall: float = 0.1,
                     scene_times: Sequence[List[float]] = None) -> Dict:
    """Per-recall-threshold metric rows (TrackingMetricData analogue).

    Returns {field: np.ndarray[nelem]} over MD_FIELDS; rows at
    unachieved recalls carry motar=0, motp=dist_th and nan elsewhere
    (reference algo.py unachieved-threshold convention).  scene_times:
    optional real frame timestamps (seconds) per scene — see
    ``accumulate_class``.
    """
    base = accumulate_class(gt_scenes, pred_scenes, dist_th, -np.inf,
                            collect_match_scores=True,
                            scene_times=scene_times)
    thresholds, recalls = _thresholds_from_base(base, nelem, min_recall)
    md = {f: np.full(nelem, np.nan) for f in MD_FIELDS}
    md['confidence'] = thresholds
    md['recall'] = recalls          # hypothetical recall axis
    cache: Dict[float, Dict] = {}
    for i, thr in enumerate(thresholds):
        if np.isnan(thr):
            md['motar'][i] = 0.0
            md['motp'][i] = dist_th
            continue
        if thr not in cache:
            cache[thr] = accumulate_class(gt_scenes, pred_scenes,
                                          dist_th, thr,
                                          scene_times=scene_times)
        st = cache[thr]
        ngt = st['gt']
        # nuScenes MOTAR uses the MEASURED recall of the row.
        r = st['recall']
        denom = r * ngt
        motar = (max(0.0, 1.0 - (st['ids'] + st['fp'] + st['fn']
                                 - (1.0 - r) * ngt) / denom)
                 if denom > 0 else float('nan'))
        md['motar'][i] = motar
        md['mota'][i] = max(0.0, 1.0 - (st['fp'] + st['fn'] + st['ids'])
                            / max(ngt, 1))
        md['motp'][i] = (st['motp'] if np.isfinite(st['motp'])
                         else dist_th)
        for f in ('faf', 'gt', 'tp', 'fp', 'fn', 'ids', 'frag',
                  'mt', 'ml', 'tid', 'lgd'):
            md[f][i] = st[f]
    return md


def summarize_curve(md: Dict, dist_th: float) -> Dict[str, float]:
    """Class summary: AMOTA/AMOTP over the curve + legacy metrics at the
    best-MOTA threshold (reference evaluate.py:143-156)."""
    out = {'amota': float(np.nanmean(md['motar'])),
           'amotp': float(np.nanmean(md['motp']))}
    mota = md['mota']
    if np.all(np.isnan(mota)):
        best = None
    else:
        best = int(np.nanargmax(mota))
    for f in ('mota', 'motp', 'recall', 'faf', 'gt', 'tp', 'fp', 'fn',
              'ids', 'frag', 'mt', 'ml', 'tid', 'lgd'):
        if best is None:
            out[f] = (0.0 if f in ('mota', 'recall') else
                      dist_th if f == 'motp' else float('nan'))
        else:
            out[f] = float(md[f][best])
    return out


def amota_amotp(gt_frames: List[List], pred_frames: List[List],
                dist_th: float, nelem: int = 40,
                min_recall: float = 0.1,
                frame_times: List[float] = None) -> Dict[str, float]:
    """Single-scene convenience wrapper (kept for the original API):
    the flat frame lists are treated as one scene."""
    md = accumulate_curve([gt_frames], [pred_frames], dist_th,
                          nelem=nelem, min_recall=min_recall,
                          scene_times=(None if frame_times is None
                                       else [frame_times]))
    return summarize_curve(md, dist_th)
