"""EDRA dissemination-tree kernel (K4) and its plain version."""
