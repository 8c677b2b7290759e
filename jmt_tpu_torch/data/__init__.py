"""Input preprocessing on the device."""
