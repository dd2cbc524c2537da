"""One module a scene ``kind`` of a configuration, found by that name. Each
has ``grids(ws, sc, g, device) -> (density [X,Y,Z,1], mask [X,Y,Z])``: the
density grid and the occupancy mask of world size ``ws`` from the
configuration's ``scene`` parameters ``sc``, drawn with the generator
``g`` on ``device``."""
