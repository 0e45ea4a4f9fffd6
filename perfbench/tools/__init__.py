"""Tools that set the limits: the readings of sound runs, of the control
and of planted faults.  The benchmark's own runs do not run them."""
