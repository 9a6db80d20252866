"""Offline info-file converter: DB -> per-frame info dicts (.pkl).

Parity target: ``newscenes_devkit/newscenes_converter_final.py``.
Per sample the info dict contains:

- ``lidar_path``, ``token``, ``prev``/``next``, ``frame_idx``,
  ``scene_token``, ``timestamp``;
- an 18-element ``can_bus``: xyz translation + wxyz quaternion +
  acc_xyz + gyro_xyz + ego velocity + 2 padding zeros
  (reference ``:101-109``);
- six camera infos with intrinsics + distortion + sensor2lidar R/T via
  the sweep->ego->global->ego'->lidar chain (reference ``:286-383``);
- six radars x 3 sweeps each, <=``max_sweeps`` lidar sweeps;
- GT boxes in SECOND yaw convention (``-yaw - pi/2``, reference
  ``:258``), names through the 12->4 NameMapping, per-box velocity and
  ``visibility`` doubling as ``valid_flag``.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import List, Tuple

import numpy as np

from omnihd_scenes_tpu_torch.devkit.database import NewScenes
from omnihd_scenes_tpu_torch.eval.detection.utils import DETECTION_MAPPING
from omnihd_scenes_tpu_torch.utils.quaternion import Quaternion

CAMERA_TYPES = ['camera_front', 'camera_left_front', 'camera_right_front',
                'camera_back', 'camera_left_back', 'camera_right_back']
RADAR_TYPES = ['radar_front', 'radar_left_front', 'radar_right_front',
               'radar_back', 'radar_left_back', 'radar_right_back']

# Raw category -> eval class; identical to the devkit eval mapping and the
# plugin's NewScenesDataset.NameMapping (reference newscenes_dataset.py:59-73).
NameMapping = DETECTION_MAPPING

RADAR_SWEEPS_PER_SENSOR = 3


def rt_to_quaternion(rt_matrix) -> Tuple[List[float], List[float]]:
    """Flat/nested 4x4 RT matrix -> ([w,x,y,z] rotation, [x,y,z] translation)."""
    tm = np.array(rt_matrix, dtype=np.float64)
    if tm.shape != (4, 4):
        tm = tm.reshape(4, 4)
    quat = Quaternion(matrix=tm[:3, :3])
    return quat.elements.astype(float).tolist(), tm[:3, 3].astype(float).tolist()


def _get_can_bus_info(lidar_pose_record: dict, canbus_record: dict) -> np.ndarray:
    rotation, translation = rt_to_quaternion(lidar_pose_record['pose'])
    can_bus = (translation + rotation + canbus_record['acc_xyz']
               + canbus_record['gyro_xyz'] + canbus_record['velocity_ego']
               + [0.0, 0.0])
    return np.array(can_bus)


def obtain_sensor2top(newsc: NewScenes, sync_token: str, scene_token: str,
                      l2e_t, l2e_r_mat, e2g_t, e2g_r_mat,
                      sensor_type: str = 'lidar') -> dict:
    """Sweep info with the RT chain from a sensor frame to the top lidar.

    The sensor2lidar transform is composed as sweep->ego->global->ego'->
    lidar using the *sweep-time* ego pose and the *sample-time* (primed)
    ego pose (reference ``newscenes_converter_final.py:365-382``).
    """
    sync_record = newsc.get('sample_data', sync_token)

    if sensor_type == 'lidar':
        data_path = osp.join(newsc.dataroot,
                             sync_record['lidar']['lidar_top_compensation'])
        cs_record = {'translation': [0.0, 0.0, 0.0],
                     'rotation': [1.0, 0.0, 0.0, 0.0]}
        ego_pose_token = sync_record['ego_pose']['lidar_top_compensation']
        sensor_timestamp = sync_token
    elif sensor_type.startswith('cam'):
        data_path = osp.join(newsc.dataroot, sync_record['cameras'][sensor_type])
        calib = newsc.get('sensor_calibration', scene_token)['calib'][sensor_type]
        rotation, translation = rt_to_quaternion(calib['camera2ego'])
        cs_record = {'translation': translation, 'rotation': rotation}
        ego_pose_token = sync_record['ego_pose']['lidar_top_compensation']
        sensor_timestamp = sync_token
    elif sensor_type.startswith('rad'):
        data_path = osp.join(newsc.dataroot, sync_record['radars'][sensor_type])
        calib = newsc.get('sensor_calibration', scene_token)['calib'][sensor_type]
        rotation, translation = rt_to_quaternion(calib['radar2ego'])
        cs_record = {'translation': translation, 'rotation': rotation}
        ego_pose_token = sync_record['ego_pose'][sensor_type]
        # Radar sweep timestamps come from the file name.
        sensor_timestamp = sync_record['radars'][sensor_type].split('/')[-1][:-4]
    else:
        raise ValueError(f'unknown sensor type {sensor_type}')

    pose_matrix = newsc.get('ego_pose', ego_pose_token, scene_token)['pose']
    canbus_record = newsc.get('imu_data', ego_pose_token, scene_token)
    rotation_pose, translation_pose = rt_to_quaternion(pose_matrix)

    sweep = {
        'data_path': data_path,
        'type': sensor_type,
        'sample_data_token': sync_token,
        'sensor2ego_translation': cs_record['translation'],
        'sensor2ego_rotation': cs_record['rotation'],
        'ego2global_translation': translation_pose,
        'ego2global_rotation': rotation_pose,
        'ego_velocity': canbus_record['velocity_ego'],
        'timestamp': sensor_timestamp,
    }

    l2e_r_s_mat = Quaternion(sweep['sensor2ego_rotation']).rotation_matrix
    e2g_r_s_mat = Quaternion(sweep['ego2global_rotation']).rotation_matrix
    l2e_t_s = np.asarray(sweep['sensor2ego_translation'], dtype=np.float64)
    e2g_t_s = np.asarray(sweep['ego2global_translation'], dtype=np.float64)
    e2g_t = np.asarray(e2g_t, dtype=np.float64)
    l2e_t = np.asarray(l2e_t, dtype=np.float64)

    inv_chain = np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
    r = (l2e_r_s_mat.T @ e2g_r_s_mat.T) @ inv_chain
    t = (l2e_t_s @ e2g_r_s_mat.T + e2g_t_s) @ inv_chain
    t -= (e2g_t @ inv_chain + l2e_t @ np.linalg.inv(l2e_r_mat).T)
    sweep['sensor2lidar_rotation'] = r.T
    sweep['sensor2lidar_translation'] = t
    return sweep


def _fill_trainval_infos(newsc: NewScenes, train_scenes, val_scenes,
                         test: bool = False, max_sweeps: int = 10):
    train_infos, val_infos = [], []

    for sample in newsc.sample:
        lidar_token = sample['token']
        sync_record = newsc.get('sample_data', sample['token'])
        pose_token = sync_record['ego_pose']['lidar_top_compensation']
        lidar_pose_record = newsc.get('ego_pose', pose_token, sample['scene_token'])
        canbus_record = newsc.get('imu_data', pose_token, sample['scene_token'])

        lidar_path = osp.join(newsc.dataroot,
                              sync_record['lidar']['lidar_top_compensation'])
        boxes = newsc.get_annotation_box(lidar_token)
        assert osp.exists(lidar_path), lidar_path

        can_bus = _get_can_bus_info(lidar_pose_record, canbus_record)

        info = {
            'lidar_path': lidar_path,
            'token': sample['token'],
            'prev': sample['prev'],
            'next': sample['next'],
            'can_bus': can_bus,
            'frame_idx': sample['frame_idx'],
            'sweeps': [],
            'cams': {},
            'radars': {},
            'scene_token': sample['scene_token'],
            'lidar2ego_translation': [0.0, 0.0, 0.0],
            'lidar2ego_rotation': [1.0, 0.0, 0.0, 0.0],
            'ego2global_translation': can_bus[:3],
            'ego2global_rotation': can_bus[3:7],
            'timestamp': sample['timestamp'],
        }

        l2e_r_mat = Quaternion(info['lidar2ego_rotation']).rotation_matrix
        e2g_r_mat = Quaternion(info['ego2global_rotation']).rotation_matrix
        l2e_t, e2g_t = info['lidar2ego_translation'], info['ego2global_translation']

        calib = newsc.get('sensor_calibration', info['scene_token'])['calib']
        for cam in CAMERA_TYPES:
            cam_info = obtain_sensor2top(newsc, sync_record['token'],
                                         info['scene_token'], l2e_t, l2e_r_mat,
                                         e2g_t, e2g_r_mat, cam)
            cam_info['cam_intrinsic'] = calib[cam]['intrinsic']
            cam_info['cam_distortion'] = calib[cam]['distortion']
            info['cams'][cam] = cam_info

        for radar_name in RADAR_TYPES:
            radar_token = sync_record['token']
            sweeps = []
            while len(sweeps) < RADAR_SWEEPS_PER_SENSOR:
                sweeps.append(obtain_sensor2top(
                    newsc, radar_token, info['scene_token'], l2e_t, l2e_r_mat,
                    e2g_t, e2g_r_mat, radar_name))
                prev = newsc.get('sample_data', radar_token)['prev']
                if prev != '':
                    radar_token = prev
            info['radars'][radar_name] = sweeps

        lidar_sweeps = []
        lidar_sweep_token = sync_record['token']
        while len(lidar_sweeps) < max_sweeps:
            prev = newsc.get('sample_data', lidar_sweep_token)['prev']
            if prev == '':
                break
            lidar_sweeps.append(obtain_sensor2top(
                newsc, prev, info['scene_token'], l2e_t, l2e_r_mat,
                e2g_t, e2g_r_mat, 'lidar'))
            lidar_sweep_token = prev
        info['sweeps'] = lidar_sweeps

        if not test:
            locs = np.array([b.center for b in boxes]).reshape(-1, 3)
            dims = np.array([b.wlh for b in boxes]).reshape(-1, 3)
            rots = np.array([b.orientation.yaw_pitch_roll[0]
                             for b in boxes]).reshape(-1, 1)
            velocity = np.array([b.velocity[:2] for b in boxes]).reshape(-1, 2)

            names = []
            for b in boxes:
                assert b.name in NameMapping, f'Do not have this class: {b.name}'
                names.append(NameMapping[b.name])

            # SECOND yaw convention.
            gt_boxes = np.concatenate([locs, dims, -rots - np.pi / 2], axis=1)
            visibility = np.array([b.visibility for b in boxes], dtype=bool)

            info['gt_boxes'] = gt_boxes
            info['gt_names'] = np.array(names)
            info['gt_velocity'] = velocity
            info['visibility'] = visibility
            info['num_lidar_pts'] = np.full(len(gt_boxes), -1, dtype=int)
            info['num_radar_pts'] = np.full(len(gt_boxes), -1, dtype=int)
            info['valid_flag'] = visibility

        if sample['scene_token'] in train_scenes:
            train_infos.append(info)
        if sample['scene_token'] in val_scenes:
            val_infos.append(info)

    return train_infos, val_infos


def merge_data_with_occ(info_path: str, out_path: str = None) -> str:
    """Add 'occ_path' to every info (reference
    ``tools/merge_data_with_occ.py:8-26``: lidar/*.bin -> occ_gt/*.npz)."""
    out_path = out_path or info_path
    with open(info_path, 'rb') as f:
        data = pickle.load(f)
    for info in data['infos']:
        info['occ_path'] = info['lidar_path'].replace(
            '/lidar/', '/occ_gt/').replace('.bin', '.npz')
    with open(out_path, 'wb') as f:
        pickle.dump(data, f)
    return out_path


def create_newscenes_infos(root_path: str, out_path: str, info_prefix: str,
                           version: str = 'v1.0-trainval',
                           max_sweeps: int = 10) -> None:
    """Generate {prefix}_infos_temporal_{train,val,test}.pkl files."""
    newsc = NewScenes(version=version, dataroot=root_path, verbose=False)

    available = ['v1.0-trainval', 'v1.0-test', 'v1.0-mini']
    assert version in available, version
    if version == 'v1.0-trainval':
        train_scenes = newsc.scene_split['train']
        val_scenes = newsc.scene_split['val']
    elif version == 'v1.0-test':
        train_scenes = newsc.scene_split['test']
        val_scenes = []
    else:
        train_scenes = newsc.scene_split['train_mini']
        val_scenes = newsc.scene_split['val_mini']

    test = 'test' in version
    train_infos, val_infos = _fill_trainval_infos(
        newsc, train_scenes, val_scenes, test, max_sweeps=max_sweeps)

    os.makedirs(out_path, exist_ok=True)
    metadata = dict(version=version)
    if test:
        with open(osp.join(out_path, f'{info_prefix}_infos_temporal_test.pkl'),
                  'wb') as f:
            pickle.dump(dict(infos=train_infos, metadata=metadata), f)
    else:
        with open(osp.join(out_path, f'{info_prefix}_infos_temporal_train.pkl'),
                  'wb') as f:
            pickle.dump(dict(infos=train_infos, metadata=metadata), f)
        with open(osp.join(out_path, f'{info_prefix}_infos_temporal_val.pkl'),
                  'wb') as f:
            pickle.dump(dict(infos=val_infos, metadata=metadata), f)
