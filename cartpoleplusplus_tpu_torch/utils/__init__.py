"""Counter-based PRNG and quaternion helpers."""
