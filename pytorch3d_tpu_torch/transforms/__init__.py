"""Transforms (port of pytorch3d_tpu/transforms): Transform3d, the rotation
conversions and the SO(3) / SE(3) maps."""
from .math import acos_linear_extrapolation
from .rotation_conversions import (
    axis_angle_to_matrix,
    axis_angle_to_quaternion,
    euler_angles_to_matrix,
    matrix_to_axis_angle,
    matrix_to_euler_angles,
    matrix_to_quaternion,
    matrix_to_rotation_6d,
    quaternion_apply,
    quaternion_invert,
    quaternion_multiply,
    quaternion_raw_multiply,
    quaternion_to_axis_angle,
    quaternion_to_matrix,
    random_quaternions,
    random_rotation,
    random_rotations,
    rotation_6d_to_matrix,
    standardize_quaternion,
)
from .se3 import se3_exp_map, se3_log_map
from .so3 import hat, hat_inv, so3_exp_map, so3_exponential_map, so3_log_map, so3_relative_angle, so3_rotation_angle
from .transform3d import Rotate, RotateAxisAngle, Scale, Transform3d, Translate

__all__ = [k for k in dir() if not k.startswith("_")]
