"""Programs the driver's ``ProgramCache`` gained during the window
(``ops/programs.py``): 0 while every shape was warmed in set-up."""

LAYER = "programs"
UNIT = "programs"
SOURCE = "program_counter"
MOVES = "iter_s"


def read(run):
    return run.program_builds
