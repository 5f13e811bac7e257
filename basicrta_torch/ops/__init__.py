"""Numerics of the port: precise f32 transcendentals and samplers."""
