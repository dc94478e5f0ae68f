"""summer_clip_torch ops."""
