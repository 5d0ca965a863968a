"""Operation and byte counts of the work a step or a frame needs, and the
H100's peaks that the roofline shares divide by."""
