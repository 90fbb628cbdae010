"""One module an op of the traffic: its call into the program and into the reference."""
