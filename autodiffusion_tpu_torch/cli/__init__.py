"""Command line of the port (``adt-torch``)."""
