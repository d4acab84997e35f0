"""Synthetic scans."""
