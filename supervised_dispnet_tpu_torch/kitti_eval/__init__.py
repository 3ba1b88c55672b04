"""KITTI evaluation harnesses (the Eigen depth split)."""
