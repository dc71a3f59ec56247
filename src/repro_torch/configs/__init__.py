"""Configuration knobs of the single-device index."""
