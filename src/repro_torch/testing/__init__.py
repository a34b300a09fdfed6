"""Test-support utilities of the port (no runtime dependency on the test stack)."""
