"""The port's codecs."""
