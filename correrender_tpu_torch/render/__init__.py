"""Cameras, transfer functions and the shear-warp volume renderer."""
