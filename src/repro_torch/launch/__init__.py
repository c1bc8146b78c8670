"""Launch helpers: the device mesh of the mesh plans (`mesh.make_mesh`)."""
