"""Inputs made from the seed: the room scene and the calibration problem."""
