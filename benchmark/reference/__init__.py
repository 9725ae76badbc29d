"""The plain reference that decides ``correct``: float32 PyTorch written
from the papers and the configuration files, importing nothing of the
measured program."""
