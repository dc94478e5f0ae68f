"""summer_clip_torch methods."""
