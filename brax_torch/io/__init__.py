"""Trajectory, parameter and metrics io: the counterpart of `brax_tpu/io`.

`file` (the open/exists/glob seam), `model` (params pickles), `npy_file`
(QP trajectories), `json` and `html` (the viewer's scene and trajectory
document and its standalone page) and `metrics` (TensorBoard event files,
written without tensorboardX or tensorboard).
"""
