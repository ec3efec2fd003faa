"""Network specs and the plaintext oracle."""
