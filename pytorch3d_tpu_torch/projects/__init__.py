"""The port's projects: the NeRF trainers (port of the repository's
projects/nerf)."""
