"""Device runtime."""
