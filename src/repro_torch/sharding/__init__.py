"""Sharding of the port: ``specs`` holds the logical-axis rules that name
each parameter's split axis, the installed mesh, and the thread-local TP
context whose ``psum_tp`` the layers call after every row-parallel
product; ``collectives`` holds the EDRA dissemination tree as rounds of
sends between the entries of a mesh axis."""
