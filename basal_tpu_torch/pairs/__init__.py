"""Paired-end alignment pipeline of the port."""
