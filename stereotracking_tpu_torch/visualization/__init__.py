from .visualizer import (ERROR_COLORS, TrackVisualizer,  # noqa: F401
                         draw_mot_errors, id_color, overlay_masks,
                         paste_mask)
