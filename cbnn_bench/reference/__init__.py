"""The plain reference forward; imports nothing of the system under test."""
