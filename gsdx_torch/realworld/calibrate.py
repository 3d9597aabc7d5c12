"""Camera calibration: ChArUco board detection + robot-world hand-eye solve
(the port's own copy of `gsdx/realworld/calibrate.py`).

Host-side OpenCV reuse, matching the reference
(`src/real_world/utils/real_env.py:80-92,402-412`,
`src/real_world/calibrate.py:12-98`): per-camera ChArUco pose gives
board->camera; with the robot holding the board,
`cv2.calibrateRobotWorldHandEye` (Tsai) yields base->world and
gripper->camera transforms. Host code with OpenCV (`cv2`, with its aruco
module), imported at first use: without it the board functions raise an
ImportError that names it; `solve_hand_eye` is numpy only.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("camera calibration needs OpenCV (`cv2`, with its "
                          "aruco module: opencv-contrib-python)") from e
    return cv2


def make_charuco_board(squares_x: int = 6, squares_y: int = 5,
                       square_len: float = 0.04, marker_len: float = 0.03):
    cv2 = _cv2()

    adict = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_50)
    board = cv2.aruco.CharucoBoard(
        (squares_x, squares_y), square_len, marker_len, adict
    )
    return board, adict


def detect_charuco_pose(image: np.ndarray, k: np.ndarray,
                        dist: Optional[np.ndarray] = None,
                        board=None) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(rvec, tvec) board pose in the camera frame, or None if not found."""
    cv2 = _cv2()

    if board is None:
        board, _ = make_charuco_board()
    if dist is None:
        dist = np.zeros(5)
    gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY) if image.ndim == 3 else image
    detector = cv2.aruco.CharucoDetector(board)
    charuco_corners, charuco_ids, _, _ = detector.detectBoard(gray)
    if charuco_corners is None or len(charuco_corners) < 4:
        return None
    # PnP on the matched chessboard corners (cv2 >= 5 dropped
    # estimatePoseCharucoBoard; this is what it did internally).
    obj = board.getChessboardCorners()[np.asarray(charuco_ids).reshape(-1)]
    ok, rvec, tvec = cv2.solvePnP(
        obj.astype(np.float64),
        np.asarray(charuco_corners).reshape(-1, 1, 2).astype(np.float64),
        np.asarray(k, np.float64), np.asarray(dist, np.float64),
    )
    if not ok:
        return None
    return rvec.reshape(3), tvec.reshape(3)


def _project_so3(m: np.ndarray) -> np.ndarray:
    u, _, vt = np.linalg.svd(m)
    return u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt


def solve_hand_eye(
    R_board2cam: List[np.ndarray], t_board2cam: List[np.ndarray],
    R_gripper2base: List[np.ndarray], t_gripper2base: List[np.ndarray],
) -> Dict[str, np.ndarray]:
    """Robot-world hand-eye (`real_env.py:380-412`): returns R/t base->world
    and R/t gripper->cam given paired board and gripper poses.

    Solves A_i X = Z B_i with A_i = board->cam (board frame == world),
    B_i = base->gripper (inverted here from the gripper->base poses the arm
    reports, as the reference does), X = base->world, Z = gripper->cam.
    Closed-form Kronecker-product method (Shah 2013) — cv2 >= 5 dropped
    calibrateRobotWorldHandEye; its Shah backend is reimplemented natively.
    """
    A_R = [np.asarray(R, np.float64) for R in R_board2cam]
    A_t = [np.asarray(t, np.float64).reshape(3) for t in t_board2cam]
    B_R = [np.asarray(R, np.float64).T for R in R_gripper2base]
    B_t = [
        -np.asarray(R, np.float64).T @ np.asarray(t, np.float64).reshape(3)
        for R, t in zip(R_gripper2base, t_gripper2base)
    ]
    n = len(A_R)

    # Rotations: maximize vec(R_Z)^T [sum_i B_i (x) A_i] vec(R_X) over SO(3)
    # (column-major vec); rank-1 SVD then orthogonal projection.
    kmat = sum(np.kron(B_R[i], A_R[i]) for i in range(n))
    u, _, vt = np.linalg.svd(kmat)
    m_z = u[:, 0].reshape(3, 3, order="F")
    m_x = vt[0].reshape(3, 3, order="F")
    if np.linalg.det(m_x) < 0:  # simultaneous sign flip of the singular pair
        m_x, m_z = -m_x, -m_z
    R_X = _project_so3(m_x)
    R_Z = _project_so3(m_z)

    # Translations: R_Ai t_X - t_Z = R_Z t_Bi - t_Ai, linear least squares.
    lhs = np.zeros((3 * n, 6))
    rhs = np.zeros(3 * n)
    for i in range(n):
        lhs[3 * i:3 * i + 3, :3] = A_R[i]
        lhs[3 * i:3 * i + 3, 3:] = -np.eye(3)
        rhs[3 * i:3 * i + 3] = R_Z @ B_t[i] - A_t[i]
    sol, *_ = np.linalg.lstsq(lhs, rhs, rcond=None)

    return {
        "R_base2world": R_X,
        "t_base2world": sol[:3],
        "R_gripper2cam": R_Z,
        "t_gripper2cam": sol[3:],
    }


def save_calibration(path: str, calib: Dict[str, np.ndarray]) -> None:
    with open(path, "wb") as f:
        pickle.dump(calib, f)


def load_calibration(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return pickle.load(f)
