"""PSMNet: the SPP tower, integer-shift concat or group-wise correlation volume, hourglass aggregation."""
