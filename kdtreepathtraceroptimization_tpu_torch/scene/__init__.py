"""Scene loading: ``scene.parser.load_scene``, ``scene.obj_loader.load_obj``
and the ``scene.structs`` containers."""
