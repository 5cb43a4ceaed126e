from .render import frames_to_gif, render_frame, render_trajectory

__all__ = ["frames_to_gif", "render_frame", "render_trajectory"]
