"""Step factories of the port (serving steps only; training waits for its
ROADMAP item)."""
