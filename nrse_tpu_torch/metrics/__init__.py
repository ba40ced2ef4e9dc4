"""The offline categorical SER scorer."""
