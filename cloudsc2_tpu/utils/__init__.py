
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Framework utilities: timing, performance output, field validation.

Rebuild of the external ``ifs_physics_common`` utility surface
(SURVEY.md §2.2: ``timing``, ``output``, ``validation`` modules), which the
reference imports from an unvendored pip dependency.
"""
