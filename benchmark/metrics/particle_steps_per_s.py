"""Particles x every step completed in the window, over the window's
seconds (the window ends when its last frame is in host memory)."""


def read(rec):
    if not rec.get("frames"):
        return None
    return rec["n_particles"] * rec["steps"] / rec["window_wall_s"]
