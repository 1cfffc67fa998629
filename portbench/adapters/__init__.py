"""See portbench/run.py."""
