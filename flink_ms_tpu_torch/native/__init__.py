"""The port's C++ sources (store, lookup server, arena) and ``_build``,
which compiles them with the host's ``g++`` at first use."""
