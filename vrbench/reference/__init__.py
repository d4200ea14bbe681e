"""The plain reference the benchmark holds the program to: the render
kernel's plain version and the tables it reads, worked out again from the
benchmark's inputs, in torch and numpy. It imports nothing of the
program."""
