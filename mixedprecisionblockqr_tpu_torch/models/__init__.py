"""Workload models: QR-based least squares and the SLAM/bundle-adjustment
Jacobian workflow."""
