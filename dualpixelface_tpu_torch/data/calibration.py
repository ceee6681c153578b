"""The RCV benchmark's calibration constants (ref dataloader/FaceDP/path_reader.py:26-29,
210, 259), shared by the FaceDP reader and the synthetic generator. They
live apart from the reader so that the SyntheticDP path imports no image
library.
"""
# per-camera pre-calibrated [a, b] of disp = a / depth + b
ABVALUE_LIST = {
    1: [-26996.48848727, 32.984822],
    2: [-25727.48737484, 31.80317696],
    3: [-24940.24188275, 30.52371982],
    4: [-25821.86619949, 32.03359466],
    5: [-26735.69581971, 33.24327157],
    6: [-22694.45143825, 27.76217617],
    7: [-23598.82548605, 29.1246567],
    8: [-26482.94764346, 32.91372342],
}

# (focal length mm, focused distance mm, f-number, pixel size um)
DEFAULT_METADATA = [135.0, 970.0, 5.657, 5.36]
THIN_LENS_K = 0.13372
