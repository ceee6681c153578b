"""StereoNet: the smallest cost-volume model of the zoo."""
