"""Tools around the port: ``profiling`` times its paths on the card."""
