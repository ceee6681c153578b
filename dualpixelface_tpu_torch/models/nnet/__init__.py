"""NNet: normal-assisted stereo on PSMNet's SPP tower."""
