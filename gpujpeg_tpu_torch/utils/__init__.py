"""Host utilities of the port: image-file I/O (:mod:`.image_io`)."""
