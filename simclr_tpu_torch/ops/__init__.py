"""Losses, augmentation and the hand-written kernels."""
