"""Point-cloud ops of the port: the curve sort and the bucket pyramid."""
