"""Protein-level driver: all residues of an event table."""
