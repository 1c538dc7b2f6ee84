"""Checkpoints, the forces csv and VTU output."""
