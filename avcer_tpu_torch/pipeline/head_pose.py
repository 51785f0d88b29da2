"""Head pose estimation from the detector's 5 facial landmarks: a copy of
avcer_tpu/pipeline/head_pose.py, pinned against it by the tests.

Behavior parity with the reference's data/face_detection/ibug/
face_detection/utils/head_pose_estimator.py: EPnP on the 5-point mean shape
derived from the Basel Face Model 68-landmark file (``bfm_lms.npy``) ->
(pitch, yaw, roll) degrees, including the reference's camera model
(focal = width + height), its y-flip of the mean shape, its exact
rotation-matrix -> Euler formulas with gimbal handling, and its
alternative-solution preference logic (:26-75). Unused by the AVCER main
path but exported by the face-detection package (__init__.py:1-5).

The 5-point mean shape is checked in as a constant: it is 15 numbers of
published Basel Face Model geometry (the mean of BFM's eye-corner landmarks
plus nose tip and mouth corners — the reference derives the same values
when it is imported, head_pose_estimator.py:14-23), so the external
``bfm_lms.npy`` asset is not needed at runtime. Passing ``mean_shape_path`` to a 68-point
file reproduces the derivation instead.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

#: 5-point mean shape derived from the BFM 68-landmark mean
#: (left eye, right eye, nose tip, left mouth corner, right mouth corner),
#: y already flipped to image coordinates (head_pose_estimator.py:14-23).
BFM_5PT_SHAPE = np.array(
    [
        [-32041.583496, -33903.172363, 93830.982422],
        [31197.034180, -33952.082031, 93603.523438],
        [-13.473192, 2389.416016, 130320.125000],
        [-25803.433594, 34191.632812, 98251.335938],
        [24834.664062, 34180.695312, 98209.085938],
    ],
    dtype=np.float64,
)

#: generic anthropometric fallback in the same image-coordinate convention
#: as BFM_5PT_SHAPE (y down: eyes negative, mouth positive; larger z =
#: farther from camera). Kept for study; the BFM-derived shape is the
#: default — see tests/test_aux.py head-pose delta test for the measured
#: angle difference between the two. (The round-2 version of this constant
#: was y-UP, which made the fallback return ~180-degree-flipped poses.)
GENERIC_5PT_SHAPE = np.array(
    [
        [-32.0, -30.0, -25.0],
        [32.0, -30.0, -25.0],
        [0.0, 0.0, 0.0],
        [-24.0, 30.0, -22.0],
        [24.0, 30.0, -22.0],
    ],
    dtype=np.float64,
)


def derive_5pt_shape(mean_shape_68: np.ndarray) -> np.ndarray:
    """The reference's 68 -> 5 point derivation + y-flip
    (head_pose_estimator.py:17-23)."""
    ms = np.asarray(mean_shape_68, np.float64)
    left_eye = ms[[37, 38, 40, 41]].mean(axis=0)
    right_eye = ms[[43, 44, 46, 47]].mean(axis=0)
    pts = np.vstack((left_eye, right_eye, ms[[30, 48, 54]]))
    pts[:, 1] = -pts[:, 1]
    return pts


class HeadPoseEstimator:
    def __init__(
        self,
        mean_shape_path: Optional[str] = None,
        mean_shape: Optional[np.ndarray] = None,
    ):
        if mean_shape is not None:
            self.mean_shape = np.asarray(mean_shape, np.float64)
        elif mean_shape_path is not None:
            self.mean_shape = derive_5pt_shape(np.load(mean_shape_path))
        else:
            self.mean_shape = BFM_5PT_SHAPE

    def __call__(
        self,
        landmarks: np.ndarray,
        image_width: int = 0,
        image_height: int = 0,
        camera_matrix: Optional[np.ndarray] = None,
        dist_coeffs: Optional[np.ndarray] = None,
        output_preference: int = 0,
    ) -> Optional[tuple[float, float, float]]:
        """landmarks: [5, 2] pixel coords (RetinaFace order: eyes, nose,
        mouth corners); 68- and 49/51-point layouts are reduced the way the
        reference does (:38-43). Returns (pitch, yaw, roll) in degrees with
        the reference's sign convention (-pitch at :75), or None when PnP
        fails."""
        import cv2

        lms = np.asarray(landmarks, dtype=np.float64).reshape(-1, 2)
        if camera_matrix is None:
            if image_width <= 0 or image_height <= 0:
                raise ValueError(
                    "image_width and image_height must be specified when "
                    "camera_matrix is not given directly"
                )
            # reference camera model: focal = width + height (:33-36)
            f = image_width + image_height
            camera_matrix = np.array(
                [[f, 0, image_width / 2.0], [0, f, image_height / 2.0],
                 [0, 0, 1]],
                dtype=np.float64,
            )
        if lms.shape[0] == 68:
            lms = lms[17:]
        if lms.shape[0] in (49, 51):
            left_eye = lms[[20, 21, 23, 24]].mean(axis=0)
            right_eye = lms[[26, 27, 29, 30]].mean(axis=0)
            lms = np.vstack((left_eye, right_eye, lms[[13, 31, 37]]))
        if lms.shape[0] < 5:
            return None

        ok, rvec, _ = cv2.solvePnP(
            self.mean_shape[:5], np.expand_dims(lms[:5], axis=1),
            camera_matrix, dist_coeffs, flags=cv2.SOLVEPNP_EPNP,
        )
        if not ok:
            return None
        rot_mat, _ = cv2.Rodrigues(rvec)

        # exact reference Euler extraction incl. gimbal branches (:49-61)
        if 1.0 + rot_mat[2, 0] < 1e-9:
            pitch = 0.0
            yaw = 90.0
            roll = -math.atan2(rot_mat[0, 1], rot_mat[0, 2]) / math.pi * 180.0
        elif 1.0 - rot_mat[2, 0] < 1e-9:
            pitch = 0.0
            yaw = -90.0
            roll = math.atan2(-rot_mat[0, 1], -rot_mat[0, 2]) / math.pi * 180.0
        else:
            pitch = math.atan2(rot_mat[2, 1], rot_mat[2, 2]) / math.pi * 180.0
            yaw = -math.asin(rot_mat[2, 0]) / math.pi * 180.0
            roll = math.atan2(rot_mat[1, 0], rot_mat[0, 0]) / math.pi * 180.0

        # alternative-solution preference (:63-73): pick the equivalent
        # rotation with the smaller total angle (or the one that puts the
        # preferred axis into -90..90)
        if output_preference != 2:
            alt_pitch = pitch - 180.0 if pitch > 0.0 else pitch + 180.0
            alt_yaw = -180.0 - yaw if yaw < 0.0 else 180.0 - yaw
            alt_roll = roll - 180.0 if roll > 0.0 else roll + 180.0
            if (
                output_preference == 1 and -90.0 < alt_pitch < 90.0
                or output_preference == 3 and -90.0 < alt_roll < 90.0
                or output_preference not in (1, 2, 3)
                and abs(alt_pitch) + abs(alt_yaw) + abs(alt_roll)
                < abs(pitch) + abs(yaw) + abs(roll)
            ):
                pitch, yaw, roll = alt_pitch, alt_yaw, alt_roll

        return -pitch, yaw, roll
