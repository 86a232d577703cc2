"""Program execution (``run_program``)."""
