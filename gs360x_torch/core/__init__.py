"""Math core of the port: camera rays, the angle helper, video colour."""
