"""Distributed incubating layers of the port."""
