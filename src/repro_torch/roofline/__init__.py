"""The H100 roofline of the dry run's records (`roofline.analysis`)."""
