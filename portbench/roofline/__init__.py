"""Work counts of the program's hand-written kernels, from the shapes a job
runs at, and the card's published peaks: a kernel's share of its roofline
is its least possible time at those peaks over its traced device time."""
