"""Host-to-device and device-to-host copies the program counted (copy.h2d
+ copy.d2h) per op of the traced window (codecbench/program.py).  Read for
every split of the quantity: copies_per_op.encode and
copies_per_op.decode."""
from codecbench import program


def read(ctx):
    return program.copies_per_op(ctx)
