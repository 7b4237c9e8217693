"""Logging and argparse helpers."""
