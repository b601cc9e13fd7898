"""Drivers of the program under test, one file each, found by the name in
a configuration's "driver". A driver builds what the window drives, runs
its compared first steps and its warm-up, follows the same steps with the
plain reference, and gives the numbers that decide `correct`; the harness
around it is the same for every cell. `train_step.py` drives an agent's
train step."""
