"""Simulation: advect (+ forces) and the pressure projection."""
