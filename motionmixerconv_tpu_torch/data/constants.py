"""Human3.6M, AMASS and AIS joint, dimension and split tables shared by the
datasets, the trainers and evaluation.

The port's own copy of the H3.6M, AMASS and AIS parts of
``motionmixerconv_tpu/data/constants.py`` (values transcribed from the
reference, file:line cited per table). The CMU tables land with their
slice.
"""

from __future__ import annotations

import numpy as np

H36M_ACTIONS = [
    "walking", "eating", "smoking", "discussion", "directions",
    "greeting", "phoning", "posing", "purchases", "sitting",
    "sittingdown", "takingphoto", "waiting", "walkingdog",
    "walkingtogether",
]  # h36m/utils/data_utils.py:291-294

# subject splits: [train, val, test] (dataset_h36m.py:41,64; split 0/1/2)
H36M_SUBJECT_SPLITS = [[1, 6, 7, 8, 9], [11], [5]]

# xyz path: 66 used dims of the 96-dim flattened 32x3 skeleton
# (train_mixer_h36m.py:77-80)
H36M_DIM_USED_XYZ = np.array(
    [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 21, 22, 23, 24, 25,
     26, 27, 28, 29, 30, 31, 32, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45,
     46, 47, 51, 52, 53, 54, 55, 56, 57, 58, 59, 63, 64, 65, 66, 67, 68,
     75, 76, 77, 78, 79, 80, 81, 82, 83, 87, 88, 89, 90, 91, 92]
)

# angle path: 48 used dims of the 99-dim expmap frame (train_mixer_h36m.py:88-90)
H36M_DIM_USED_ANGLE = np.array(
    [6, 7, 8, 9, 12, 13, 14, 15, 21, 22, 23, 24, 27, 28, 29, 30, 36, 37, 38,
     39, 40, 41, 42, 43, 44, 45, 46, 47, 51, 52, 53, 54, 55, 56, 57, 60, 61,
     62, 75, 76, 77, 78, 79, 80, 81, 84, 85, 86]
)

# constant/duplicate joints dropped from the xyz skeleton (dataset_h36m.py:193)
H36M_JOINT_TO_IGNORE_DATASET = np.array([0, 1, 6, 11, 16, 20, 23, 24, 28, 31])

# eval-time re-insertion of equal joints (train_mixer_h36m.py:301-306)
H36M_JOINT_TO_IGNORE_EVAL = np.array([16, 20, 23, 24, 28, 31])
H36M_JOINT_EQUAL_EVAL = np.array([13, 19, 22, 13, 27, 30])


def _expand_joint_dims(joints: np.ndarray) -> np.ndarray:
    return np.concatenate((joints * 3, joints * 3 + 1, joints * 3 + 2))


H36M_INDEX_TO_IGNORE_EVAL = _expand_joint_dims(H36M_JOINT_TO_IGNORE_EVAL)
H36M_INDEX_TO_EQUAL_EVAL = _expand_joint_dims(H36M_JOINT_EQUAL_EVAL)


def h36m_dimensions_to_use_xyz() -> np.ndarray:
    """96-dim mask complement of the ignored joints (dataset_h36m.py:192-195)."""
    ignore = _expand_joint_dims(H36M_JOINT_TO_IGNORE_DATASET)
    return np.setdiff1d(np.arange(96), ignore)


def define_actions(action: str) -> list[str]:
    """Parity with h36m/utils/data_utils.py:279-307."""
    if action in H36M_ACTIONS:
        return [action]
    if action == "all":
        return list(H36M_ACTIONS)
    raise ValueError(f"Unrecognized action: {action}")


# --- AMASS -------------------------------------------------------------------

# dataset-directory splits: [train, val, test] (dataloader_amass.py:42-46)
AMASS_SPLITS = [
    ["CMU", "MPI_Limits", "TotalCapture", "Eyes_Japan_Dataset", "KIT",
     "EKUT", "TCD_handMocap", "ACCAD"],
    ["HumanEva", "MPI_HDM05", "SFU", "MPI_mosh"],
    ["BioMotionLab_NTroje"],
]

# 18 moving joints of the 22-joint body (dataloader_amass.py:39)
AMASS_JOINT_USED = np.arange(4, 22)
AMASS_TARGET_FPS = 25
# their 54 coordinates in the flat (52 * 3) frame, the model's input
AMASS_DIM_USED = np.arange(12, 66)


# --- AIS ---------------------------------------------------------------------

AIS_NUM_KPS_USED = 19  # dataset_ais_xyz.py:85
AIS_ROOT_JOINT = 8  # MidHip (dataset_ais_xyz.py:118)
AIS_NECK_JOINT = 1
AIS_LHIP_JOINT = 12
AIS_RHIP_JOINT = 9

# trainer's ignored joints: Nose, MidHip, RHip, LHip, REye, LEye, REar, LEar
# (train_mixer_ais.py:119-125)
AIS_JOINTS_TO_IGNORE = np.array([1, 8, 9, 12, 15, 16, 17, 18])
AIS_DIM_USED = np.setdiff1d(
    np.arange(AIS_NUM_KPS_USED * 3), _expand_joint_dims(AIS_JOINTS_TO_IGNORE)
)

# action splits used by the AIS trainer (train_mixer_ais.py:84-111, 295-299)
AIS_TRAIN_ACTIONS = [
    "2021-08-04-singlePerson_000",
    "2021-08-04-singlePerson_001",
    "2021-08-04-singlePerson_003",
    "2022-05-26_2persons_000",
    "2022-05-26_2persons_003",
]
AIS_VAL_ACTIONS = ["2022-05-26_2persons_001"]
AIS_TEST_ACTIONS = ["2021-08-04-singlePerson_002", "2022-05-26_2persons_002"]
AIS_ALL_ACTIONS = [
    "2021-08-04-singlePerson_000",
    "2021-08-04-singlePerson_001",
    "2021-08-04-singlePerson_002",
    "2021-08-04-singlePerson_003",
    "2022-05-26_2persons_000",
    "2022-05-26_2persons_001",
    "2022-05-26_2persons_002",
    "2022-05-26_2persons_003",
]
