"""Seconds from the harness's first statement to the window's start:
imports, the CUDA context, the kernel and scene-builder libraries (built
on a checkout's first run), the scene, the Simulator and the first frame,
which captures the period graph."""


def read(rec):
    return rec["setup_s"]
