"""Alignment pipeline of the port."""
