"""setup_s: from the start of run.py to the first timed frame: the
interpreter's imports, the CUDA context, the scene, the cold build, the
warm-up frames with their calibrations and captures (host clock)."""


def read(rec):
    return rec["setup_s"]
