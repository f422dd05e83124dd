"""Launch-side steps of the port: serving (prefill + decode)."""
