"""Lattice ops of the port: segment reductions, BCL, correlation BCL."""
